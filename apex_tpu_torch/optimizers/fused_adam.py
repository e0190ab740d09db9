"""FusedAdam (counterpart of ``apex_tpu/optimizers/fused_adam.py``).

Two paths, as in the JAX package:

- default, the tree path: per-leaf fp32 updates in plain PyTorch, as the
  JAX package's default path is plain ``jnp`` (no kernel);
- ``use_flat_kernel=True``: m and v live as packed ``(rows, 128)``
  buffers in the JAX layout (``multi_tensor_apply.flatten``) and ONE
  ``flat_adam`` kernel steps them. Grads and params are flattened to
  fp32 buffers every step and the new params are views of the kernel's
  output buffer. The kernel handles ``found_inf`` itself (it writes the
  old values), so this path makes no select pass over params or state.
"""

from typing import Any, NamedTuple, Tuple

import torch

from apex_tpu_torch.multi_tensor_apply.kernels import flat_adam
from apex_tpu_torch.optimizers._common import (
    FusedOptimizer, f32, tree_unzip,
)
from apex_tpu_torch.utils.tree import tree_map


class AdamState(NamedTuple):
    step: torch.Tensor  # 0-d int32
    m: Any
    v: Any


class FusedAdam(FusedOptimizer):
    """Adam (AdamW with ``adam_w_mode``), bias-corrected unless
    ``bias_correction=False`` (then c1 = c2 = 1); ``init`` and ``step``
    are ``FusedOptimizer``'s."""

    State = AdamState

    def __init__(self, lr: float = 1e-3, bias_correction: bool = True,
                 betas: Tuple[float, float] = (0.9, 0.999), eps: float = 1e-8,
                 adam_w_mode: bool = True, weight_decay: float = 0.0,
                 amsgrad: bool = False, *, use_flat_kernel: bool = False,
                 m_dtype: torch.dtype = torch.float32,
                 emit_compute_params: bool = False):
        if amsgrad:
            raise RuntimeError(
                "FusedAdam does not support the AMSGrad variant.")
        super().__init__(use_flat_kernel=use_flat_kernel, m_dtype=m_dtype,
                         emit_compute_params=emit_compute_params)
        self.lr = lr
        self.bias_correction = bias_correction
        self.beta1, self.beta2 = betas
        self.eps = eps
        self.adam_w_mode = adam_w_mode
        self.weight_decay = weight_decay

    def _tree_step(self, grads, params, state):
        dev = state.step.device
        lr, wd, b1, b2, eps = (f32(x, dev) for x in (
            self.lr, self.weight_decay, self.beta1, self.beta2, self.eps))
        t = state.step + 1
        tf = t.to(torch.float32)
        one = f32(1.0, dev)
        if self.bias_correction:
            c1, c2 = one - b1 ** tf, one - b2 ** tf
        else:
            c1 = c2 = one
        aw = self.adam_w_mode
        md = self.m_dtype

        def upd(g, p, m, v):
            g = g.to(torch.float32)
            p32 = p.to(torch.float32)
            if not aw:
                g = g + wd * p32
            m = b1 * m.to(torch.float32) + (one - b1) * g
            v = b2 * v + (one - b2) * g * g
            u = (m / c1) / (torch.sqrt(v / c2) + eps)
            if aw:
                u = u + wd * p32
            return (p32 - lr * u).to(p.dtype), m.to(md), v

        out = tree_map(upd, grads, params, state.m, state.v)
        new_params, new_m, new_v = tree_unzip(out, 3)
        return new_params, AdamState(step=t, m=new_m, v=new_v)

    def _flat_update(self, gbuf, pbuf, state, t, layout, emit, found_inf):
        outs = flat_adam(
            gbuf, pbuf, state.m, state.v, lr=self.lr, beta1=self.beta1,
            beta2=self.beta2, eps=self.eps, step=t,
            weight_decay=self.weight_decay, adam_w_mode=self.adam_w_mode,
            bias_correction=self.bias_correction, emit_compute_dtype=emit,
            found_inf=found_inf)
        return outs[0], dict(m=outs[1], v=outs[2]), \
            outs[3] if emit else None

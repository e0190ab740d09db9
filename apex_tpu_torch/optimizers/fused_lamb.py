"""FusedLAMB (counterpart of ``apex_tpu/optimizers/fused_lamb.py``).

LAMB is Adam's update scaled per tensor: grads clipped by their GLOBAL
norm, Adam-style moments and the raw update ``u = m^ / (sqrt(v^) + eps)
+ wd p`` (stage 1), then each tensor's step ``lr * ||p|| / ||u|| * u``
(stage 2, the trust ratio). Two paths, as in the JAX package:

- default, the tree path: per-leaf fp32 updates in plain PyTorch, as the
  JAX package's default path is plain ``jnp`` (no kernel);
- ``use_flat_kernel=True``: m and v live as packed ``(rows, 128)``
  buffers in the JAX layout; grads and params are flattened to fp32
  buffers every step and ``flat_lamb`` steps them (the grad-norm
  pre-pass and stage 1 are kernels, stage 2 PyTorch). The kernel handles
  ``found_inf`` itself (old m and v, and the old p), so this path makes
  no select pass over params or state.
"""

from typing import Any, NamedTuple, Tuple

import torch

from apex_tpu_torch.multi_tensor_apply.kernels import flat_lamb
from apex_tpu_torch.optimizers._common import (
    FusedOptimizer, f32, global_grad_norm, tree_unzip,
)
from apex_tpu_torch.utils.tree import tree_map


class LambState(NamedTuple):
    step: torch.Tensor  # 0-d int32
    m: Any
    v: Any


class FusedLAMB(FusedOptimizer):
    """LAMB with bias correction and grad averaging (the JAX defaults,
    the only values any caller uses); ``init`` and ``step`` are
    ``FusedOptimizer``'s, with the signature of ``FusedAdam``'s."""

    State = LambState

    def __init__(self, lr: float = 1e-3,
                 betas: Tuple[float, float] = (0.9, 0.999), eps: float = 1e-6,
                 weight_decay: float = 0.01, amsgrad: bool = False,
                 adam_w_mode: bool = True, max_grad_norm: float = 1.0,
                 use_nvlamb: bool = False, *, use_flat_kernel: bool = False,
                 m_dtype: torch.dtype = torch.float32,
                 emit_compute_params: bool = False):
        if amsgrad:
            raise RuntimeError(
                "FusedLAMB does not support the AMSGrad variant.")
        super().__init__(use_flat_kernel=use_flat_kernel, m_dtype=m_dtype,
                         emit_compute_params=emit_compute_params)
        self.lr = lr
        self.beta1, self.beta2 = betas
        self.eps = eps
        self.weight_decay = weight_decay
        self.adam_w_mode = adam_w_mode
        self.max_grad_norm = max_grad_norm
        # NVLAMB: the trust ratio even for tensors without weight decay
        self.use_nvlamb = use_nvlamb

    def _tree_step(self, grads, params, state):
        dev = state.step.device
        lr, wd, b1, b2, eps = (f32(x, dev) for x in (
            self.lr, self.weight_decay, self.beta1, self.beta2, self.eps))
        one = f32(1.0, dev)
        t = state.step + 1
        tf = t.to(torch.float32)
        beta3 = one - b1
        c1, c2 = one - b1 ** tf, one - b2 ** tf
        # stage 1 preamble: clip by the global grad norm
        grad_norm = global_grad_norm(tree_map(lambda g: g.float(), grads))
        max_norm = f32(self.max_grad_norm, dev)
        clip = torch.where((max_norm > 0) & (grad_norm > max_norm),
                           grad_norm / max_norm, one)
        aw, md = self.adam_w_mode, self.m_dtype

        def upd(g, p, m, v):
            g = g.float() / clip
            p32 = p.float()
            if not aw:
                g = g + wd * p32
            m = b1 * m.float() + beta3 * g
            v = b2 * v + (one - b2) * g * g
            u = (m / c1) / (torch.sqrt(v / c2) + eps)
            if aw:
                u = u + wd * p32
            # stage 2: the tensor's trust ratio
            w_norm = torch.sqrt(torch.sum(p32 * p32))
            u_norm = torch.sqrt(torch.sum(u * u))
            ratio = torch.where((w_norm > 0) & (u_norm > 0),
                                w_norm / u_norm, one)
            if not self.use_nvlamb:
                # the reference's decoupled-wd group split: with no
                # weight decay a tensor skips the ratio
                ratio = torch.where(wd == 0.0, one, ratio)
            return (p32 - lr * ratio * u).to(p.dtype), m.to(md), v

        out = tree_map(upd, grads, params, state.m, state.v)
        new_params, new_m, new_v = tree_unzip(out, 3)
        return new_params, LambState(step=t, m=new_m, v=new_v)

    def _flat_update(self, gbuf, pbuf, state, t, layout, emit, found_inf):
        tile_ids, tile_counts = layout[3:]
        return flat_lamb(
            gbuf, pbuf, state.m, state.v, tile_ids, tile_counts, lr=self.lr,
            beta1=self.beta1, beta2=self.beta2, eps=self.eps, step=t,
            weight_decay=self.weight_decay, adam_w_mode=self.adam_w_mode,
            use_nvlamb=self.use_nvlamb, max_grad_norm=self.max_grad_norm,
            emit_compute_dtype=emit, found_inf=found_inf)

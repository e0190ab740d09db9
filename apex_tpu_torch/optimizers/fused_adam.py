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

from typing import Any, NamedTuple, Optional, Tuple

import torch

from apex_tpu_torch.multi_tensor_apply.flatten import (
    flatten_tensors, unflatten_pytree, zeros_buffer,
)
from apex_tpu_torch.multi_tensor_apply.kernels import flat_adam
from apex_tpu_torch.optimizers._common import (
    check_m_dtype, f32, finish_compute_params, flat_layout, select_finite,
    tree_unzip, tree_zeros,
)
from apex_tpu_torch.utils.tree import tree_flatten, tree_leaves, tree_map


class AdamState(NamedTuple):
    step: torch.Tensor  # 0-d int32
    m: Any
    v: Any


class FusedAdam:
    def __init__(self, lr: float = 1e-3,
                 betas: Tuple[float, float] = (0.9, 0.999), eps: float = 1e-8,
                 adam_w_mode: bool = True, weight_decay: float = 0.0,
                 amsgrad: bool = False, *, use_flat_kernel: bool = False,
                 m_dtype: torch.dtype = torch.float32,
                 emit_compute_params: bool = False):
        if amsgrad:
            raise RuntimeError(
                "FusedAdam does not support the AMSGrad variant.")
        self.lr = lr
        self.beta1, self.beta2 = betas
        self.eps = eps
        self.adam_w_mode = adam_w_mode
        self.weight_decay = weight_decay
        # reduced-precision first moment (fp32 accumulate, v stays fp32)
        self.m_dtype = check_m_dtype(m_dtype)
        # fused cast-out: step also returns the updated params cast to
        # the compute dtypes (amp O2 then skips its per-step cast)
        self.emit_compute_params = emit_compute_params
        self.use_flat_kernel = use_flat_kernel
        self._specs = {}  # flat layouts, by tree structure and leaf shapes

    def init(self, params: Any) -> AdamState:
        dev = tree_leaves(params)[0].device
        step = torch.zeros((), dtype=torch.int32, device=dev)
        if self.use_flat_kernel:
            _, _, spec = flat_layout(self._specs, params)
            return AdamState(step=step,
                             m=zeros_buffer(spec, self.m_dtype, dev),
                             v=zeros_buffer(spec, torch.float32, dev))
        return AdamState(step=step, m=tree_zeros(params, self.m_dtype),
                         v=tree_zeros(params, torch.float32))

    def step(self, grads: Any, params: Any, state: AdamState, *,
             found_inf: Optional[torch.Tensor] = None,
             compute_params: Optional[Any] = None):
        """One bias-corrected optimizer step on unscaled gradients (the
        loss scaler's ``unscale`` comes first).

        With ``found_inf`` True the step is skipped: params, m, v and the
        step count stay put. With ``emit_compute_params`` the return
        grows to ``(params, state, compute)``, the updated params cast to
        the dtypes of ``compute_params`` (or bf16 without it)."""
        if self.use_flat_kernel:
            new_params, new_state, pc = self._flat_step(grads, params, state,
                                                        found_inf)
        else:
            new_params, new_state = self._tree_step(grads, params, state)
            new_params = select_finite(found_inf, new_params, params)
            new_state = select_finite(found_inf, new_state, state)
            pc = None
        if not self.emit_compute_params:
            return new_params, new_state
        if pc is not None and compute_params is not None:
            # the kernel casts out to bf16; leaves whose compute dtype
            # differs (the fp32 LayerNorm leaves) are cast from the master
            pc = tree_map(lambda c, tmpl, p: c if c.dtype == tmpl.dtype
                          else p.to(tmpl.dtype), pc, compute_params,
                          new_params)
        compute = finish_compute_params(new_params, params, compute_params,
                                        found_inf, precomputed=pc)
        return new_params, new_state, compute

    def _tree_step(self, grads, params, state):
        dev = state.step.device
        lr, wd, b1, b2, eps = (f32(x, dev) for x in (
            self.lr, self.weight_decay, self.beta1, self.beta2, self.eps))
        t = state.step + 1
        tf = t.to(torch.float32)
        one = f32(1.0, dev)
        c1 = one - b1 ** tf
        c2 = one - b2 ** tf
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

    def _flat_step(self, grads, params, state, found_inf):
        leaves, treedef, spec = flat_layout(self._specs, params)
        gbuf, _ = flatten_tensors(tree_flatten(grads)[0], spec)
        pbuf, _ = flatten_tensors(leaves, spec)
        t = state.step + 1
        emit = torch.bfloat16 if self.emit_compute_params else None
        outs = flat_adam(
            gbuf, pbuf, state.m, state.v, lr=self.lr, beta1=self.beta1,
            beta2=self.beta2, eps=self.eps, step=t,
            weight_decay=self.weight_decay, adam_w_mode=self.adam_w_mode,
            emit_compute_dtype=emit, found_inf=found_inf)
        new_params = unflatten_pytree(outs[0], spec, treedef)
        pc = None if emit is None else \
            unflatten_pytree(outs[3], spec, treedef, cast_back=False)
        if found_inf is not None:  # the step count stays put too
            t = torch.where(found_inf, state.step, t)
        return new_params, AdamState(step=t, m=outs[1], v=outs[2]), pc

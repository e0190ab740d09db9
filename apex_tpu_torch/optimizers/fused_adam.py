"""FusedAdam (counterpart of ``apex_tpu/optimizers/fused_adam.py``), the
tree path: per-leaf fp32 updates in plain PyTorch, as the JAX package's
default path is plain ``jnp`` (no kernel). The flat-buffer path
(``use_flat_kernel=True``, the Pallas ``_adam_kernel``) is not ported
yet.
"""

from typing import Any, NamedTuple, Optional, Tuple

import torch

from apex_tpu_torch.optimizers._common import (
    check_m_dtype, f32, finish_compute_params, select_finite, tree_unzip,
    tree_zeros,
)
from apex_tpu_torch.utils.tree import tree_leaves, tree_map


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
        if use_flat_kernel:
            raise NotImplementedError(
                "use_flat_kernel: the flat Adam kernel (multi_tensor_apply/"
                "kernels.py _adam_kernel, row 16 of the kernel table in "
                "PERF.md) is not ported yet (ROADMAP queue A3); the tree "
                "path is the default")
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

    def init(self, params: Any) -> AdamState:
        dev = tree_leaves(params)[0].device
        return AdamState(step=torch.zeros((), dtype=torch.int32, device=dev),
                         m=tree_zeros(params, self.m_dtype),
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
        new_params, new_state = self._tree_step(grads, params, state)
        new_params = select_finite(found_inf, new_params, params)
        new_state = select_finite(found_inf, new_state, state)
        if not self.emit_compute_params:
            return new_params, new_state
        compute = finish_compute_params(new_params, params, compute_params,
                                        found_inf)
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

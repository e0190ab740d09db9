"""FusedAdagrad (counterpart of ``apex_tpu/optimizers/fused_adagrad.py``).

Two paths, as in the JAX package: the tree path (per-leaf fp32 updates
in plain PyTorch) and ``use_flat_kernel=True`` (the sum lives as one
packed ``(rows, 128)`` fp32 buffer and ONE ``flat_adagrad`` kernel steps
it and the flattened params in place, ``found_inf`` included).
Adagrad's only state is the sum of squared gradients: there is no first
moment, so no ``m_dtype`` (the sum stays fp32).
"""

from typing import Any, NamedTuple

import torch

from apex_tpu_torch.multi_tensor_apply.kernels import flat_adagrad
from apex_tpu_torch.optimizers._common import (
    FusedOptimizer, f32, tree_unzip,
)
from apex_tpu_torch.utils.tree import tree_map


class AdagradState(NamedTuple):
    step: torch.Tensor  # 0-d int32
    sum: Any


class FusedAdagrad(FusedOptimizer):
    """Adagrad, with decoupled weight decay under ``adagrad_w_mode``.
    ``init`` and ``step`` are ``FusedOptimizer``'s."""

    State = AdagradState

    def __init__(self, lr: float = 1e-2, eps: float = 1e-10,
                 weight_decay: float = 0.0, adagrad_w_mode: bool = False,
                 *, use_flat_kernel: bool = False,
                 emit_compute_params: bool = False):
        super().__init__(use_flat_kernel=use_flat_kernel,
                         m_dtype=torch.float32,
                         emit_compute_params=emit_compute_params)
        self.lr = lr
        self.eps = eps
        self.weight_decay = weight_decay
        self.adagrad_w_mode = adagrad_w_mode

    def _zero_state(self, params, spec):
        return dict(sum=self._zeros(params, spec, torch.float32))

    def _tree_step(self, grads, params, state):
        dev = state.step.device
        lr, eps, wd = (f32(x, dev) for x in (self.lr, self.eps,
                                              self.weight_decay))
        w = self.adagrad_w_mode

        def upd(g, p, s):
            g = g.float()
            p32 = p.float()
            if not w:
                g = g + wd * p32
            s = s + g * g
            u = g / (torch.sqrt(s) + eps)
            if w:
                u = u + wd * p32
            return (p32 - lr * u).to(p.dtype), s

        out = tree_map(upd, grads, params, state.sum)
        new_params, new_sum = tree_unzip(out, 2)
        return new_params, AdagradState(step=state.step + 1, sum=new_sum)

    def _flat_update(self, gbuf, pbuf, state, t, layout, emit, found_inf):
        outs = flat_adagrad(
            gbuf, pbuf, state.sum, lr=self.lr, eps=self.eps,
            weight_decay=self.weight_decay,
            adagrad_w_mode=self.adagrad_w_mode, emit_compute_dtype=emit,
            found_inf=found_inf)
        return outs[0], dict(sum=outs[1]), outs[2] if emit else None

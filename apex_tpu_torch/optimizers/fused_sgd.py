"""FusedSGD (counterpart of ``apex_tpu/optimizers/fused_sgd.py``).

Momentum, Nesterov, dampening and weight decay as ``torch.optim.SGD``
has them, as the reference does; the first momentum step seeds the
buffer with the gradient (the reference's ``first_run``), read from the
step count on the device, so a step skipped on an overflow leaves the
next one still first. Two paths, as in the JAX package:

- default, the tree path: per-leaf fp32 updates in plain PyTorch;
- ``use_flat_kernel=True``: the momentum buffer lives as one packed
  ``(rows, 128)`` buffer in the JAX layout and ONE ``flat_sgd`` kernel
  steps it and the flattened params in place; the kernel handles
  ``found_inf`` itself.
"""

from typing import Any, NamedTuple

import torch

from apex_tpu_torch.multi_tensor_apply.kernels import flat_sgd
from apex_tpu_torch.optimizers._common import (
    FusedOptimizer, f32, scaled, tree_unzip,
)
from apex_tpu_torch.utils.tree import tree_map


class SGDState(NamedTuple):
    step: torch.Tensor  # 0-d int32
    momentum_buf: Any


class FusedSGD(FusedOptimizer):
    """SGD with momentum; ``m_dtype`` is the momentum buffer's (fp32 or
    bf16, fp32 accumulate). ``init`` and ``step`` are
    ``FusedOptimizer``'s."""

    State = SGDState

    def __init__(self, lr: float, momentum: float = 0.0,
                 dampening: float = 0.0, weight_decay: float = 0.0,
                 nesterov: bool = False, *, wd_after_momentum: bool = False,
                 use_flat_kernel: bool = False,
                 m_dtype: torch.dtype = torch.float32,
                 emit_compute_params: bool = False):
        if nesterov and (momentum <= 0 or dampening != 0):
            raise ValueError(
                "Nesterov momentum requires a momentum and zero dampening")
        super().__init__(use_flat_kernel=use_flat_kernel, m_dtype=m_dtype,
                         emit_compute_params=emit_compute_params)
        self.lr = lr
        self.momentum = momentum
        self.dampening = dampening
        self.weight_decay = weight_decay
        self.nesterov = nesterov
        self.wd_after_momentum = wd_after_momentum

    def _zero_state(self, params, spec):
        return dict(momentum_buf=self._zeros(params, spec, self.m_dtype))

    def _tree_step(self, grads, params, state, args):
        dev = state.step.device
        lr, wd, gs = args.lr, args.weight_decay, args.grad_scale
        mom, damp = (f32(x, dev) for x in (self.momentum, self.dampening))
        one = f32(1.0, dev)
        first = state.step == 0

        def upd(g, p, buf):
            g = scaled(g, gs)
            p32 = p.float()
            if not self.wd_after_momentum:
                g = g + wd * p32
            if self.momentum > 0:
                seeded = torch.where(first, g,
                                     mom * buf.float() + (one - damp) * g)
                d = g + mom * seeded if self.nesterov else seeded
                buf = seeded.to(self.m_dtype)
            else:
                d = g
            if self.wd_after_momentum:
                d = d + wd * p32
            return (p32 - lr * d).to(p.dtype), buf

        out = tree_map(upd, grads, params, state.momentum_buf)
        new_params, new_buf = tree_unzip(out, 2)
        return new_params, SGDState(step=state.step + 1,
                                    momentum_buf=new_buf)

    def _flat_update(self, gbuf, pbuf, state, t, layout, emit, found_inf,
                     args):
        outs = flat_sgd(
            gbuf, pbuf, state.momentum_buf, lr=args.lr,
            momentum=self.momentum, dampening=self.dampening,
            weight_decay=args.weight_decay, nesterov=self.nesterov,
            wd_after_momentum=self.wd_after_momentum,
            first_run=state.step == 0, grad_scale=args.grad_scale,
            emit_compute_dtype=emit, found_inf=found_inf)
        return outs[0], dict(momentum_buf=outs[1]), \
            outs[2] if emit else None

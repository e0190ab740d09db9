"""FusedNovoGrad (counterpart of ``apex_tpu/optimizers/fused_novograd.py``).

NovoGrad keeps its second moment as ONE fp32 scalar per tensor (the
layer-wise EMA of ||g||^2); the first step seeds it with ||g||^2 unless
``init_zero``. Two paths, as in the JAX package:

- default, the tree path: per-leaf fp32 updates in plain PyTorch, v a
  tree of 0-d tensors;
- ``use_flat_kernel=True``: m lives as one packed ``(rows, 128)`` buffer
  in the JAX layout and v as a ``(num_tensors,)`` vector; ``flat_novograd``
  takes the per-tensor ||g||^2 from the L2 partials kernel, updates v in
  PyTorch on the device and steps m and the flattened params in place
  with one kernel, ``found_inf`` included.
"""

from typing import Any, NamedTuple, Tuple

import torch

from apex_tpu_torch.multi_tensor_apply.kernels import flat_novograd
from apex_tpu_torch.optimizers._common import (
    FusedOptimizer, f32, tree_unzip,
)
from apex_tpu_torch.utils.tree import tree_map


class NovoGradState(NamedTuple):
    step: torch.Tensor  # 0-d int32
    m: Any
    v: Any  # per-tensor fp32 scalars


class FusedNovoGrad(FusedOptimizer):
    """NovoGrad; ``bias_correction=False`` takes c1 = c2 = 1,
    ``grad_averaging=False`` beta3 = 1, ``reg_inside_moment`` folds the
    weight decay into m. ``init`` and ``step`` are
    ``FusedOptimizer``'s."""

    State = NovoGradState

    def __init__(self, lr: float = 1e-3,
                 betas: Tuple[float, float] = (0.95, 0.98), eps: float = 1e-8,
                 weight_decay: float = 0.0, amsgrad: bool = False,
                 reg_inside_moment: bool = False, grad_averaging: bool = True,
                 norm_type: int = 2, init_zero: bool = False,
                 bias_correction: bool = True, *,
                 use_flat_kernel: bool = False,
                 m_dtype: torch.dtype = torch.float32,
                 emit_compute_params: bool = False):
        super().__init__(use_flat_kernel=use_flat_kernel, m_dtype=m_dtype,
                         emit_compute_params=emit_compute_params)
        if amsgrad:
            raise RuntimeError(
                "FusedNovoGrad does not support the AMSGrad variant.")
        if norm_type != 2:
            raise ValueError("FusedNovoGrad only supports norm_type=2")
        self.lr = lr
        self.beta1, self.beta2 = betas
        self.eps = eps
        self.weight_decay = weight_decay
        self.reg_inside_moment = reg_inside_moment
        self.grad_averaging = grad_averaging
        self.init_zero = init_zero
        self.bias_correction = bias_correction

    def _zero_state(self, params, spec):
        m = self._zeros(params, spec, self.m_dtype)
        if spec is not None:
            return dict(m=m, v=torch.zeros((spec.num_tensors,),
                                           dtype=torch.float32,
                                           device=m.device))
        return dict(m=m, v=tree_map(lambda p: torch.zeros(
            (), dtype=torch.float32, device=p.device), params))

    def _tree_step(self, grads, params, state):
        dev = state.step.device
        lr, wd, b1, b2, eps = (f32(x, dev) for x in (
            self.lr, self.weight_decay, self.beta1, self.beta2, self.eps))
        one = f32(1.0, dev)
        t = state.step + 1
        tf = t.to(torch.float32)
        first = state.step == 0
        beta3 = one - b1 if self.grad_averaging else one
        if self.bias_correction:
            c1, c2 = one - b1 ** tf, one - b2 ** tf
        else:
            c1 = c2 = one
        reg = self.reg_inside_moment

        def upd(g, p, m, v):
            g = g.float()
            p32 = p.float()
            gsq = torch.sum(g * g)
            ema = b2 * v + (one - b2) * gsq
            v = ema if self.init_zero else torch.where(first, gsq, ema)
            gn = g / (torch.sqrt(v / c2) + eps)
            if reg:
                gn = gn + wd * p32
            m = b1 * m.float() + beta3 * gn
            u = m / c1
            if not reg:
                u = u + wd * p32
            return (p32 - lr * u).to(p.dtype), m.to(self.m_dtype), v

        out = tree_map(upd, grads, params, state.m, state.v)
        new_params, new_m, new_v = tree_unzip(out, 3)
        return new_params, NovoGradState(step=t, m=new_m, v=new_v)

    def _flat_update(self, gbuf, pbuf, state, t, layout, emit, found_inf):
        tile_ids, tile_counts = layout[3:]
        outs = flat_novograd(
            gbuf, pbuf, state.m, state.v, tile_ids, tile_counts, lr=self.lr,
            beta1=self.beta1, beta2=self.beta2, eps=self.eps, step=t,
            weight_decay=self.weight_decay,
            grad_averaging=self.grad_averaging,
            bias_correction=self.bias_correction,
            reg_inside_moment=self.reg_inside_moment,
            init_zero=self.init_zero, emit_compute_dtype=emit,
            found_inf=found_inf)
        return outs[0], dict(m=outs[1], v=outs[2]), \
            outs[3] if emit else None

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

from typing import Any, NamedTuple, Optional, Tuple

import torch

from apex_tpu_torch.multi_tensor_apply.kernels import flat_lamb
from apex_tpu_torch.optimizers._common import (
    FusedOptimizer, StepArgs, f32, global_grad_norm, scaled, tree_unzip,
)
from apex_tpu_torch.utils.tree import tree_map


class LambState(NamedTuple):
    step: torch.Tensor  # 0-d int32
    m: Any
    v: Any


class FusedLAMB(FusedOptimizer):
    """LAMB; ``bias_correction=False`` takes c1 = c2 = 1 and
    ``grad_averaging=False`` beta3 = 1 (the m update's weight on g).
    ``init`` is ``FusedOptimizer``'s; ``step`` takes the reference's
    arguments in its order, ``grad_norm=`` among them."""

    State = LambState

    def __init__(self, lr: float = 1e-3, bias_correction: bool = True,
                 betas: Tuple[float, float] = (0.9, 0.999), eps: float = 1e-6,
                 weight_decay: float = 0.01, amsgrad: bool = False,
                 adam_w_mode: bool = True, grad_averaging: bool = True,
                 max_grad_norm: float = 1.0,
                 use_nvlamb: bool = False, *, use_flat_kernel: bool = False,
                 m_dtype: torch.dtype = torch.float32,
                 emit_compute_params: bool = False):
        if amsgrad:
            raise RuntimeError(
                "FusedLAMB does not support the AMSGrad variant.")
        super().__init__(use_flat_kernel=use_flat_kernel, m_dtype=m_dtype,
                         emit_compute_params=emit_compute_params)
        self.lr = lr
        self.bias_correction = bias_correction
        self.beta1, self.beta2 = betas
        self.eps = eps
        self.weight_decay = weight_decay
        self.adam_w_mode = adam_w_mode
        self.grad_averaging = grad_averaging
        self.max_grad_norm = max_grad_norm
        # NVLAMB: the trust ratio even for tensors without weight decay
        self.use_nvlamb = use_nvlamb

    def step(self, grads: Any, params: Any, state: LambState, *, lr=None,
             weight_decay=None, grad_scale=1.0,
             grad_norm: Optional[torch.Tensor] = None,
             found_inf: Optional[torch.Tensor] = None,
             compute_params: Optional[Any] = None):
        """``FusedOptimizer.step``'s arguments, and ``grad_norm``: the
        global norm of the scaled gradients, when the caller has it (then
        the grad-norm pre-pass is not run)."""
        args = StepArgs(self.lr if lr is None else lr,
                        self.weight_decay if weight_decay is None
                        else weight_decay, grad_scale, grad_norm)
        return self._step(grads, params, state, args, found_inf,
                          compute_params)

    def _tree_step(self, grads, params, state, args):
        dev = state.step.device
        lr, wd, gs, grad_norm = args
        b1, b2, eps = (f32(x, dev) for x in (self.beta1, self.beta2,
                                             self.eps))
        one = f32(1.0, dev)
        t = state.step + 1
        tf = t.to(torch.float32)
        beta3 = one - b1 if self.grad_averaging else one
        if self.bias_correction:
            c1, c2 = one - b1 ** tf, one - b2 ** tf
        else:
            c1 = c2 = one
        # stage 1 preamble: clip by the global grad norm
        if grad_norm is None:
            grad_norm = global_grad_norm(tree_map(lambda g: scaled(g, gs),
                                                  grads))
        max_norm = f32(self.max_grad_norm, dev)
        clip = torch.where((max_norm > 0) & (grad_norm > max_norm),
                           grad_norm / max_norm, one)
        aw, md = self.adam_w_mode, self.m_dtype

        def upd(g, p, m, v):
            g = scaled(g, gs) / clip
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

    def _flat_update(self, gbuf, pbuf, state, t, layout, emit, found_inf,
                     args):
        tile_ids, tile_counts = layout[3:]
        outs = flat_lamb(
            gbuf, pbuf, state.m, state.v, tile_ids, tile_counts, lr=args.lr,
            beta1=self.beta1, beta2=self.beta2, eps=self.eps, step=t,
            weight_decay=args.weight_decay, adam_w_mode=self.adam_w_mode,
            grad_averaging=self.grad_averaging,
            bias_correction=self.bias_correction,
            use_nvlamb=self.use_nvlamb, max_grad_norm=self.max_grad_norm,
            grad_scale=args.grad_scale, grad_norm=args.grad_norm,
            emit_compute_dtype=emit, found_inf=found_inf)
        return outs[0], dict(m=outs[1], v=outs[2]), \
            outs[3] if emit else None

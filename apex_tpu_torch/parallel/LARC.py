"""LARC, layer-wise adaptive rate control (counterpart of
``apex_tpu/parallel/LARC.py``): wraps one of the fused optimizers and
rescales each leaf's gradient so the leaf's effective learning rate is
``trust_coefficient * ||p|| / (||g|| + weight_decay * ||p|| + eps)``,
clipped at the base rate with ``clip=True``; then the inner optimizer
steps with ``lr=`` and ``weight_decay=0.0`` (the decay is folded into
the gradient, before the trust-ratio factor, as the reference folds it).

Per leaf, in fp32, in the JAX package's order of operations: the two
norms, the factor, ``(g + wd p) * factor``; a leaf whose param or
gradient norm is 0 keeps its gradient untouched. Everything stays on
the device (selects, no host read); the inner step's flat kernel runs
as it does without LARC.
"""

from typing import Any, Optional, Tuple

import torch

from apex_tpu_torch.optimizers._common import f32
from apex_tpu_torch.utils.tree import tree_leaves, tree_map


class LARC:
    def __init__(self, optimizer, trust_coefficient: float = 0.02,
                 clip: bool = True, eps: float = 1e-8):
        self.optim = optimizer
        self.trust_coefficient = trust_coefficient
        self.clip = clip
        self.eps = eps

    def init(self, params: Any):
        return self.optim.init(params)

    def step(self, grads: Any, params: Any, state, *, lr=None,
             weight_decay=None, found_inf: Optional[torch.Tensor] = None,
             **kw) -> Tuple[Any, Any]:
        dev = tree_leaves(params)[0].device
        base_lr = f32(lr if lr is not None else self.optim.lr, dev)
        wd = f32(weight_decay if weight_decay is not None
                 else getattr(self.optim, "weight_decay", 0.0), dev)
        tc, eps = f32(self.trust_coefficient, dev), f32(self.eps, dev)
        one = f32(1.0, dev)

        def rescale(g, p):
            g32 = g.float()
            p32 = p.float()
            p_norm = torch.sqrt(torch.sum(p32 * p32))
            g_norm = torch.sqrt(torch.sum(g32 * g32))
            adaptive_lr = tc * p_norm / (g_norm + p_norm * wd + eps)
            if self.clip:
                # the layer's rate min(adaptive, base): the gradient times
                # min(adaptive / base, 1), the inner step at the base rate
                factor = torch.minimum(adaptive_lr / base_lr, one)
            else:
                # the layer's rate base * adaptive
                factor = adaptive_lr
            nonzero = (p_norm > 0) & (g_norm > 0)
            return torch.where(nonzero, (g32 + wd * p32) * factor,
                               g32).to(g.dtype)

        grads = tree_map(rescale, grads, params)
        return self.optim.step(grads, params, state, lr=lr,
                               weight_decay=0.0, found_inf=found_inf, **kw)

"""Weight normalization, w = g * v / ||v|| (Salimans and Kingma 2016;
counterpart of ``apex_tpu/reparameterization/weight_norm.py``;
reference: ``apex/reparameterization/weight_norm.py`` and
``reparameterization.py``, module hooks splitting a weight into a
magnitude ``g`` and a direction ``v`` with an fp16-safe fused norm).

As in the JAX package, a pair of tensor functions in place of module
hooks: :func:`apply_weight_norm` splits a weight into ``(g, v)``,
:func:`compute_weight` rebuilds w (differentiable: autograd carries the
gradients to g and v) and :func:`remove_weight_norm` fuses them back.
The norm is taken over every axis but ``dim`` (the reference's default
0), in fp32 whatever the storage dtype (float64 stays float64), floored
at 1e-12; the result is in v's dtype.
"""

from typing import Tuple

import torch


def _norm_keep(v: torch.Tensor, dim: int) -> torch.Tensor:
    axes = tuple(i for i in range(v.dim()) if i != dim % max(v.dim(), 1))
    v32 = v.to(torch.promote_types(v.dtype, torch.float32))
    sq = v32 * v32
    # no axis left (a 1-D v): the norm of each element, as jnp.sum over ()
    return torch.sqrt(torch.sum(sq, dim=axes, keepdim=True) if axes else sq)


def apply_weight_norm(weight: torch.Tensor, dim: int = 0
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Split w into (g, v) with w == g * v / ||v|| at the start: v = w,
    g = ||w|| over every axis but ``dim``, in w's dtype."""
    g = _norm_keep(weight, dim).to(weight.dtype)
    return g, weight


def compute_weight(g: torch.Tensor, v: torch.Tensor,
                   dim: int = 0) -> torch.Tensor:
    """w = g * v / ||v||: the norm in fp32 (the reference kernel's
    fp16-safe promotion), the result in v's dtype."""
    norm = _norm_keep(v, dim)
    wide = norm.dtype
    w = v.to(wide) / torch.clamp_min(norm, 1e-12) * g.to(wide)
    return w.to(v.dtype)


def remove_weight_norm(g: torch.Tensor, v: torch.Tensor,
                       dim: int = 0) -> torch.Tensor:
    """Fuse (g, v) back into a plain weight (ref:
    ``remove_weight_norm``)."""
    return compute_weight(g, v, dim)

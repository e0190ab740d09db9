"""Shared helpers for the fused optimizers (counterpart of
``apex_tpu/optimizers/_common.py``).

Every optimizer is functional, as in the JAX package::

    opt = FusedAdam(lr=1e-3)
    state = opt.init(params)
    params, state = opt.step(grads, params, state [, found_inf=...])

``found_inf`` (the scaler's 0-d bool tensor) turns the step into a
no-op by selects on the device, with no host sync.
"""

from typing import Any, Optional, Tuple

import torch

from apex_tpu_torch.amp.scaler import apply_if_finite
from apex_tpu_torch.multi_tensor_apply.flatten import FlatSpec, make_spec
from apex_tpu_torch.utils.tree import tree_flatten, tree_map

# dtypes accepted for the first moment (``m_dtype``): fp32 is exact apex
# semantics; bf16 halves its bytes, accumulated in fp32 and stored
# round-to-nearest-even (v always stays fp32).
_STATE_DTYPES = (torch.float32, torch.bfloat16)


def check_m_dtype(m_dtype: torch.dtype) -> torch.dtype:
    if m_dtype not in _STATE_DTYPES:
        raise ValueError(
            f"m_dtype must be torch.float32 or torch.bfloat16, got "
            f"{m_dtype}")
    return m_dtype


def tree_zeros(params: Any, dtype: torch.dtype) -> Any:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=dtype,
                                          device=p.device), params)


def select_finite(found_inf: Optional[torch.Tensor], new: Any,
                  old: Any) -> Any:
    """Keep ``old`` wherever the step must be skipped (None = never)."""
    if found_inf is None:
        return new
    return apply_if_finite(new, old, found_inf)


def f32(x, device) -> torch.Tensor:
    """A 0-d fp32 tensor: constants in fp32 arithmetic, as ``jnp.float32``
    gives them (``1 - f32(0.9)`` is not ``f32(1 - 0.9)``)."""
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def tree_unzip(out: Any, n: int) -> Tuple[Any, ...]:
    """Split a tree of dicts and lists whose leaves are n-tuples into n
    trees (as in JAX, a tuple is taken for a leaf)."""
    def go(node, i):
        if isinstance(node, dict):
            return {k: go(v, i) for k, v in node.items()}
        if isinstance(node, list):
            return [go(v, i) for v in node]
        return node[i]
    return tuple(go(out, i) for i in range(n))


def cast_like(tree: Any, template: Optional[Any],
              default_dtype: torch.dtype = torch.bfloat16) -> Any:
    """Cast each floating leaf of ``tree`` to the dtype of the matching
    ``template`` leaf (``default_dtype`` when ``template`` is None): the
    tree path's compute-param emission."""
    if template is None:
        return tree_map(lambda x: x.to(default_dtype)
                        if x.is_floating_point() else x, tree)
    return tree_map(lambda x, t: x.to(t.dtype)
                    if x.is_floating_point() else x, tree, template)


def finish_compute_params(new_params: Any, params: Any,
                          compute_params: Optional[Any],
                          found_inf: Optional[torch.Tensor],
                          precomputed: Optional[Any] = None) -> Any:
    """Shared tail of ``emit_compute_params``: ``precomputed`` (the
    kernel's cast-out, on the flat path) or else the new params cast to
    the dtypes of ``compute_params`` (the previous compute tree, also the
    cheap old value on an overflow step) or to bf16 without it."""
    new_c = precomputed if precomputed is not None else \
        cast_like(new_params, compute_params)
    if found_inf is None:
        return new_c
    old_c = compute_params if compute_params is not None else \
        cast_like(params, None)
    return apply_if_finite(new_c, old_c, found_inf)


def flat_layout(cache: dict, params: Any) -> Tuple[list, Any, FlatSpec]:
    """Cached flat-buffer layout for the ``use_flat_kernel`` paths:
    ``(leaves, treedef, spec)``, the leaves in JAX's order. Keyed by the
    tree's structure and its leaves' shapes and dtypes: one optimizer
    may serve several trees."""
    leaves, treedef = tree_flatten(params)
    key = (repr(treedef), tuple((tuple(l.shape), l.dtype) for l in leaves))
    spec = cache.get(key)
    if spec is None:
        spec = cache[key] = make_spec(leaves)
    return leaves, treedef, spec

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
from apex_tpu_torch.multi_tensor_apply.flatten import (
    SUBLANES, FlatSpec, flatten_tensors, make_spec, unflatten_pytree,
    zeros_buffer,
)
from apex_tpu_torch.multi_tensor_apply.multi_tensor_apply import (
    multi_tensor_l2norm,
)
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


def tree_zeros_f32(params: Any) -> Any:
    return tree_zeros(params, torch.float32)


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


def global_grad_norm(grads: Any) -> torch.Tensor:
    """The fp32 L2 norm over every leaf, the leaves in JAX's order."""
    return multi_tensor_l2norm(tree_flatten(grads)[0])


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
    """Shared tail of ``emit_compute_params``: ``precomputed`` (the flat
    path's bf16 cast-out tree) or else the new params cast to the dtypes
    of ``compute_params`` (the previous compute tree, also the cheap old
    value on an overflow step) or to bf16 without it. Leaves of
    ``precomputed`` whose compute dtype differs (the fp32 LayerNorm
    leaves) are cast from the new params."""
    if precomputed is None:
        new_c = cast_like(new_params, compute_params)
    elif compute_params is None:
        new_c = precomputed
    else:
        new_c = tree_map(lambda c, tmpl, p: c if c.dtype == tmpl.dtype
                         else p.to(tmpl.dtype), precomputed, compute_params,
                         new_params)
    if found_inf is None:
        return new_c
    old_c = compute_params if compute_params is not None else \
        cast_like(params, None)
    return apply_if_finite(new_c, old_c, found_inf)


def flat_layout(cache: dict, params: Any
                ) -> Tuple[list, Any, FlatSpec, torch.Tensor, torch.Tensor]:
    """Cached flat-buffer layout for the ``use_flat_kernel`` paths:
    ``(leaves, treedef, spec, tile_ids, tile_counts)``, the leaves in
    JAX's order. ``tile_ids`` is ``spec.tile_tensor_ids(8)`` and
    ``tile_counts`` ``spec.tile_counts(8)``, both on the params' device
    (LAMB's per-tensor sums read them every step; they are built once,
    not copied to the device each step). Keyed by the tree's structure,
    its leaves' shapes and dtypes and their device: one optimizer may
    serve several trees."""
    leaves, treedef = tree_flatten(params)
    key = (repr(treedef), tuple((tuple(l.shape), l.dtype) for l in leaves),
           str(leaves[0].device))
    ent = cache.get(key)
    if ent is None:
        spec = make_spec(leaves)
        dev = leaves[0].device
        ent = cache[key] = (spec, spec.tile_tensor_ids(SUBLANES).to(dev),
                            spec.tile_counts(SUBLANES).to(dev))
    return (leaves, treedef) + ent


class FusedOptimizer:
    """What the fused optimizers share: the state (a 0-d int32 step count
    beside the subclass's buffers, by leaf or flat), the dispatch between
    the tree path (plain PyTorch) and the flat path (kernels), the
    ``found_inf`` skip and the compute-param tail.

    A subclass sets ``State``, a NamedTuple whose first field is ``step``
    and whose other fields keep the JAX state's names, and gives:

    - ``_zero_state(params, spec)``: those other fields, zeroed, as a
      dict (``spec`` the flat layout on the flat path, None on the tree
      path; :meth:`_zeros` makes one zeroed buffer of either kind). The
      default is Adam's and LAMB's: a first moment m in ``m_dtype`` and
      a second moment v in fp32;
    - ``_tree_step(grads, params, state)``: ``(params, state)``;
    - ``_flat_update(gbuf, pbuf, state, t, layout, emit, found_inf)``:
      the flat kernel's ``(p buffer, {field: new state}, compute buffer
      or None)``, with ``t`` the new step count."""

    State: type

    def __init__(self, *, use_flat_kernel: bool, m_dtype: torch.dtype,
                 emit_compute_params: bool):
        # reduced-precision first moment (fp32 accumulate; second moments
        # and sums stay fp32)
        self.m_dtype = check_m_dtype(m_dtype)
        # fused cast-out: step also returns the updated params cast to
        # the compute dtypes (amp O2 then skips its per-step cast)
        self.emit_compute_params = emit_compute_params
        self.use_flat_kernel = use_flat_kernel
        self._specs = {}  # flat layouts, by tree structure and leaf shapes

    @staticmethod
    def _zeros(params: Any, spec: Optional[FlatSpec],
               dtype: torch.dtype) -> Any:
        """A zeroed state buffer: flat for ``spec``, else by leaf."""
        if spec is not None:
            return zeros_buffer(spec, dtype, tree_flatten(params)[0][0]
                                .device)
        return tree_zeros(params, dtype)

    def _zero_state(self, params: Any, spec: Optional[FlatSpec]) -> dict:
        return dict(m=self._zeros(params, spec, self.m_dtype),
                    v=self._zeros(params, spec, torch.float32))

    def init(self, params: Any):
        dev = tree_flatten(params)[0][0].device
        step = torch.zeros((), dtype=torch.int32, device=dev)
        spec = flat_layout(self._specs, params)[2] \
            if self.use_flat_kernel else None
        return self.State(step=step, **self._zero_state(params, spec))

    def step(self, grads: Any, params: Any, state, *,
             found_inf: Optional[torch.Tensor] = None,
             compute_params: Optional[Any] = None):
        """One step on unscaled gradients (the loss scaler's ``unscale``
        comes first).

        With ``found_inf`` True the step is skipped: params, the state
        and the step count stay put. With ``emit_compute_params`` the
        return grows to ``(params, state, compute)``, the updated params
        cast to the dtypes of ``compute_params`` (or bf16 without it)."""
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
        compute = finish_compute_params(new_params, params, compute_params,
                                        found_inf, precomputed=pc)
        return new_params, new_state, compute

    def _flat_step(self, grads, params, state, found_inf):
        """Grads and params flattened to fp32 buffers, the subclass's
        kernel, and the new params as views of its output buffer. The
        kernel handles ``found_inf`` itself (it writes the old values), so
        this path makes no select pass over params or state."""
        layout = flat_layout(self._specs, params)
        leaves, treedef, spec = layout[:3]
        gbuf, _ = flatten_tensors(tree_flatten(grads)[0], spec)
        pbuf, _ = flatten_tensors(leaves, spec)
        t = state.step + 1
        emit = torch.bfloat16 if self.emit_compute_params else None
        p_new, fields, pc_buf = self._flat_update(gbuf, pbuf, state, t,
                                                  layout, emit, found_inf)
        new_params = unflatten_pytree(p_new, spec, treedef)
        pc = None if pc_buf is None else \
            unflatten_pytree(pc_buf, spec, treedef, cast_back=False)
        if found_inf is not None:  # the step count stays put too
            t = torch.where(found_inf, state.step, t)
        return new_params, self.State(step=t, **fields), pc

"""ASP, automatic 2:4 structured sparsity (counterpart of
``apex_tpu/contrib/sparsity/asp.py``; reference:
``apex/contrib/sparsity/asp.py :: class ASP`` and ``sparse_masklib.py``,
``m4n2_1d``: in every group of four consecutive weights along the input
dimension keep the two largest magnitudes).

The workflow: compute the masks once on a trained model, apply them,
and fine-tune with an optimizer whose steps re-apply them. The
reference hooks a mutable ``optimizer.step``; here, as in the JAX
package, :meth:`ASP.wrap_optimizer` wraps a functional
``step(grads, params, state, **kw)``. The mask is a double stable
``argsort`` of |w| in groups of four, as ``jnp.argsort`` (stable) ranks
them, so tied magnitudes (zeros, bf16 weights) keep the JAX package's
choice bit for bit. Masking buys no FLOPs by itself: the port's kernels
do not use the card's 2:4 sparse tensor cores.
"""

from typing import Any, Callable, Optional, Tuple

import torch

from apex_tpu_torch.utils.tree import tree_map, tree_map_with_path


def m4n2_1d_mask(w: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Boolean keep-mask: the top 2 of each 4 |w| along ``axis``. This
    package's dense kernels are (in, out), so the contraction dimension,
    along which sparse tensor cores need the 2:4 pattern, is axis 0, the
    default (torch's (out, in) Linear prunes its last dimension)."""
    w = torch.movedim(w, axis, -1)
    if w.shape[-1] % 4:
        raise ValueError(
            f"pruning dim {w.shape[-1]} not divisible by 4 (m4n2 pattern)")
    groups = w.abs().reshape(*w.shape[:-1], w.shape[-1] // 4, 4)
    # rank within each group (stable: ties keep their order, as
    # jnp.argsort); keep the two largest magnitudes
    order = torch.argsort(torch.argsort(groups, dim=-1, stable=True),
                          dim=-1, stable=True)
    keep = order >= 2
    return torch.movedim(keep.reshape(w.shape), -1, axis)


def _default_predicate(path: tuple, leaf: torch.Tensor) -> bool:
    """Prunable: float matrices with a contraction (first) dimension
    divisible by 4 and both dimensions at least 16, except
    embedding-like leaves (a (vocab, h) word table is a gather table,
    not a GEMM operand): 'embed', 'embedding' or 'lookup' anywhere in
    the key path. Models with other names pass their own predicate."""
    if not (isinstance(leaf, torch.Tensor) and leaf.dim() == 2
            and leaf.shape[0] % 4 == 0 and min(leaf.shape) >= 16
            and leaf.is_floating_point()):
        return False
    path_str = "/".join(str(k) for k in path).lower()
    return not any(tag in path_str
                   for tag in ("embed", "embedding", "lookup"))


def compute_sparse_masks(params: Any,
                         predicate: Optional[Callable] = None) -> Any:
    """A mask tree: the m4n2 mask of each prunable leaf, the scalar
    ``True`` for every other leaf (no dense all-True tensors;
    :func:`apply_masks` skips them). ``predicate(path, leaf)`` gets the
    key path as ``utils.tree.tree_map_with_path`` gives it."""
    pred = predicate or _default_predicate

    def mask_of(path, leaf):
        if pred(path, leaf):
            return m4n2_1d_mask(leaf)
        return True

    return tree_map_with_path(mask_of, params)


def apply_masks(params: Any, masks: Any) -> Any:
    return tree_map(
        lambda p, m: p if m is True
        else torch.where(m, p, torch.zeros_like(p)),
        params, masks)


class ASP:
    """The functional ASP workflow::

        asp = ASP()
        masks = asp.compute_sparse_masks(params)   # after pretraining
        params = apply_masks(params, masks)
        step = asp.wrap_optimizer(opt, masks)      # masked fine-tuning
        params, opt_state = step(grads, params, opt_state)

    (ref: ``init_model_for_pruning``, ``init_optimizer_for_pruning`` and
    ``compute_sparse_masks``.)"""

    def __init__(self, predicate: Optional[Callable] = None):
        self.predicate = predicate

    def compute_sparse_masks(self, params: Any) -> Any:
        return compute_sparse_masks(params, self.predicate)

    def wrap_optimizer(self, optimizer, masks: Any):
        """A ``step(grads, params, state, **kw)`` that masks the
        gradients first (no moment builds up in a pruned slot) and then
        the updated params."""

        def step(grads, params, state, **kw
                 ) -> Tuple[Any, Any]:
            grads = apply_masks(grads, masks)
            new_params, new_state = optimizer.step(grads, params, state,
                                                   **kw)
            return apply_masks(new_params, masks), new_state

        return step

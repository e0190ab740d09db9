"""Param-tree casting (counterpart of ``apex_tpu/amp/policy.py``).

The model is a dict tree of tensors, so "cast the model" maps over the
floating leaves. With ``keep_batchnorm_fp32``, leaves whose path names
a normalization parameter stay fp32. The path markers are copied
exactly from the JAX package: they match none of the GPT tree's
``ln1``/``ln2``/``final_ln`` paths, so under O2 every GPT leaf becomes
bf16 there, and here too; BERT's ``layernorm`` leaves stay fp32.
"""

from typing import Any, Callable, Optional

import torch

from apex_tpu_torch.utils.tree import tree_map

_NORM_PATH_MARKERS = (
    "batchnorm", "batch_norm", "bn", "layernorm", "layer_norm", "norm",
    "groupnorm", "group_norm", "rmsnorm", "rms_norm",
)


def default_norm_predicate(path: tuple) -> bool:
    joined = "/".join(str(k) for k in path).lower()
    return any(m in joined for m in _NORM_PATH_MARKERS)


def _map_with_path(fn, tree, pre, path=()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, None if pre is None else pre[k],
                                  path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(
            _map_with_path(fn, v, None if pre is None else pre[i],
                           path + (i,))
            for i, v in enumerate(tree))
    return fn(path, tree, pre)


def cast_params(params: Any, dtype: torch.dtype,
                keep_batchnorm_fp32: bool = False,
                norm_predicate: Optional[Callable[[tuple], bool]] = None,
                precast: Optional[Any] = None) -> Any:
    """Cast floating leaves of a param tree to ``dtype`` (O2/O3 model
    cast); norm-path leaves stay fp32 under ``keep_batchnorm_fp32``.
    ``precast`` (an optimizer's cast-out tree, ``FusedAdam(
    emit_compute_params=True)``) is taken leaf for leaf wherever its
    dtype already is the target, so those leaves read no master bytes."""
    pred = norm_predicate or default_norm_predicate

    def cast(path, x, pre):
        if not (isinstance(x, torch.Tensor) and x.is_floating_point()):
            return x
        target = torch.float32 if (keep_batchnorm_fp32 and pred(path)) \
            else dtype
        if pre is not None and pre.dtype == target:
            return pre
        return x.to(target)

    return _map_with_path(cast, params, precast)


def master_params(params: Any) -> Any:
    """fp32 master copy of a (possibly reduced-precision) param tree
    (``apex.amp.master_params``)."""
    return cast_inputs(params, torch.float32)


def model_params_from_master(master: Any, like: Any,
                             precast: Optional[Any] = None) -> Any:
    """Re-cast master weights to the dtypes of the compute tree ``like``;
    leaves of ``precast`` (an optimizer's cast-out) whose dtype already
    matches ``like`` are taken as they are."""
    def cast(m, lk, pc=None):
        if not isinstance(lk, torch.Tensor):
            return m
        if pc is not None and pc.dtype == lk.dtype:
            return pc
        return m.to(lk.dtype)

    if precast is None:
        return tree_map(cast, master, like)
    return tree_map(cast, master, like, precast)


def cast_inputs(batch: Any, dtype: torch.dtype) -> Any:
    """Cast the floating tensors of a batch (a tree) to the compute dtype
    (the O2 input cast); integer tensors and other leaves pass through."""
    def cast(path, x, pre):
        if isinstance(x, torch.Tensor) and x.is_floating_point():
            return x.to(dtype)
        return x

    return _map_with_path(cast, batch, None)

"""Checkpoint save and restore of training-state trees (counterpart of
``apex_tpu/utils/checkpoint.py``; reference: the ``--resume`` path of
``examples/imagenet/main_amp.py``, ``torch.save`` / ``torch.load`` of
model, optimizer and ``amp.state_dict()``).

A checkpoint is one pickle (``torch.save``) of the tree with every
tensor moved to the host: dicts, lists, tuples and NamedTuples (the
optimizers' states) keep their structure, Python and numpy scalars stay
as they are, and every dtype, bf16 included, round-trips bit for bit
(torch tensors carry their own dtype; no ``ml_dtypes`` is needed).
:func:`load_checkpoint` gives host tensors: the caller moves them to its
device, as the JAX package's caller lets JAX transfer numpy on use.
Files written by the JAX package are not read.

Writes are atomic: a temp file in the target's directory, then
``os.replace``, so a kill mid-save never leaves a torn checkpoint and no
``.tmp`` file stays behind, even when the write raises.

The sharded pair is the ZeRO path. Each process holds its own rows of
the optimizer state at rest (``DistributedFusedAdam.partition_spec()``
names the ``data`` axis on the rows), so each rank writes its own file:
its block of every sharded leaf under the block's global slice
``((start, stop), ...)``, and every replicated leaf dense, the
reference's records (``{"kind": "sharded", "shape", "shards"}`` and
``{"kind": "dense", "array"}``). The template carries no shardings in
the port, so both functions take the spec tree (``specs=``) that the
state's ``partition_spec()`` gives. A load returns this rank's blocks
and never gathers; a file whose slices do not cover this rank's block
(another data-parallel size) raises the reference's "resume topology
mismatch".
"""

import os
import tempfile
from typing import Any, Optional

import torch

from apex_tpu_torch.transformer import parallel_state as ps
from apex_tpu_torch.utils.tree import tree_flatten, tree_map, tree_unflatten


def _host(x):
    return x.detach().cpu() if isinstance(x, torch.Tensor) else x


def save_checkpoint(path: str, tree: Any) -> None:
    """Atomically save a tree of tensors (device tensors are copied to
    the host)."""
    _atomic_pickle(path, tree_map(_host, tree))


def load_checkpoint(path: str) -> Any:
    """Load a tree saved by :func:`save_checkpoint`: host tensors, in
    the saved structure and dtypes."""
    return torch.load(path, map_location="cpu", weights_only=False)


def _atomic_pickle(path: str, obj: Any) -> None:
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            torch.save(obj, f)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


class _Leaf:
    """A leaf and its spec, one node for :func:`tree_flatten`."""

    def __init__(self, x, spec):
        self.x, self.spec = x, spec


def _leaf_specs(specs, tree):
    """(leaves in JAX's order, one spec a leaf): ``specs`` a prefix of
    ``tree`` (as ``shard_map`` reads it); every leaf replicated without
    ``specs``."""
    if specs is None:
        leaves = tree_flatten(tree)[0]
        return leaves, [ps.PartitionSpec()] * len(leaves)
    pairs = tree_flatten(ps._map_specs(_Leaf, specs, tree))[0]
    return [p.x for p in pairs], [p.spec for p in pairs]


def _block(shape, spec, local: bool):
    """(global shape, this rank's slice key ``((start, stop), ...)``)
    of a leaf under ``spec``; ``local`` says the leaf is this rank's
    block, else the whole value."""
    mesh = ps.get_mesh()
    shape = list(shape)
    cuts = {}
    for dim, axes in ps._spec_dims(spec):
        idx, n = ps._axis_index_and_size(mesh, axes)
        if local:
            shape[dim] *= n
        elif shape[dim] % n:
            raise ValueError(f"dimension {dim} of size {shape[dim]} does "
                             f"not split over {n} ranks of {axes}")
        cuts[dim] = (idx, n)
    key = []
    for dim, size in enumerate(shape):
        idx, n = cuts.get(dim, (0, 1))
        step = size // n
        key.append((idx * step, (idx + 1) * step))
    return tuple(shape), tuple(key)


def _sharded(spec) -> bool:
    mesh = ps.get_mesh() if ps.model_parallel_is_initialized() else None
    return mesh is not None and any(
        ps._axis_index_and_size(mesh, axes)[1] > 1
        for _, axes in ps._spec_dims(spec))


def save_sharded_checkpoint(path: str, tree: Any, *,
                            specs: Optional[Any] = None) -> None:
    """Atomically save this rank's part of a tree held at rest under
    ``specs`` (each leaf this rank's block where its spec names an axis
    of more than one rank): one record a leaf, its block under its
    global slice, or the whole leaf dense. Give each rank its own
    ``path``."""
    leaves, lspecs = _leaf_specs(specs, tree)
    recs = []
    for leaf, spec in zip(leaves, lspecs):
        if not (isinstance(leaf, torch.Tensor) and _sharded(spec)):
            recs.append({"kind": "dense", "array": _host(leaf)})
            continue
        shape, key = _block(leaf.shape, spec, local=True)
        recs.append({"kind": "sharded", "shape": shape,
                     "shards": {key: _host(leaf)}})
    _atomic_pickle(path, recs)


def load_sharded_checkpoint(path: str, template: Any, *,
                            specs: Optional[Any] = None) -> Any:
    """Load a :func:`save_sharded_checkpoint` file into ``template``'s
    structure (e.g. a freshly initialized state, whole or this rank's
    blocks): each sharded leaf as this rank's block under ``specs``,
    dense leaves whole; tensors on the template leaf's device. Raises
    where the file's slices do not cover this rank's block."""
    recs = torch.load(path, map_location="cpu", weights_only=False)
    leaves_t, lspecs = _leaf_specs(specs, template)
    _, treedef = tree_flatten(template)
    if len(recs) != len(leaves_t):
        raise ValueError(
            f"checkpoint has {len(recs)} leaves, template has "
            f"{len(leaves_t)} — structure mismatch")
    out = []
    for rec, tmpl, spec in zip(recs, leaves_t, lspecs):
        if rec["kind"] == "dense":
            arr = rec["array"]
            if getattr(tmpl, "shape", None) is not None \
                    and tuple(getattr(arr, "shape", ())) != tuple(tmpl.shape):
                raise ValueError(
                    f"dense leaf shape {tuple(getattr(arr, 'shape', ()))} "
                    f"!= template {tuple(tmpl.shape)}")
            out.append(arr.to(tmpl.device) if isinstance(arr, torch.Tensor)
                       and isinstance(tmpl, torch.Tensor) else arr)
            continue
        _, key = _block(rec["shape"], spec, local=False)
        local = tuple(b - a for a, b in key)
        if tuple(tmpl.shape) not in (tuple(rec["shape"]), local):
            raise ValueError(
                f"sharded leaf shape {rec['shape']} != template "
                f"{tuple(tmpl.shape)}")
        shards = rec["shards"]
        if key not in shards:
            raise ValueError(
                "resume topology mismatch: checkpoint shard slices "
                f"{sorted(shards)} do not cover requested {key}; "
                "resume with the same mesh/dp layout it was saved "
                "under (or gather via the dense checkpoint path)")
        out.append(shards[key].to(tmpl.device))
    return tree_unflatten(treedef, out)

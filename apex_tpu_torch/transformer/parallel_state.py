"""Model- and data-parallel state over ``torch.distributed`` process
groups (counterpart of ``apex_tpu/transformer/parallel_state.py``;
reference: ``apex/transformer/parallel_state.py ::
initialize_model_parallel``).

The JAX package builds one device mesh with four named axes and treats
each axis name as the "group". The port keeps the four axes and the
JAX mesh's layout, ``reshape(dp, pp, cp, tp)`` with ``model`` innermost,
over the ranks of the default process group: rank r sits where the JAX
mesh puts device r. Each axis becomes a ``torch.distributed`` process
group, one for each line of ranks along it, and ``get_*_group()``
returns this rank's ``ProcessGroup`` (the apex meaning):

- ``data``    — data parallelism (gradient all-reduce);
- ``pipe``    — pipeline stages;
- ``context`` — context parallelism (ring attention);
- ``model``   — tensor parallelism.

``new_group`` is collective: every rank creates every group, in one
order, and the groups are cached (the axes' at bring-up, the subgroups
``axis_index_groups`` asks for at first use), so later calls create
nothing. Ranks and world sizes are plain ints (the JAX package's are
traced axis indices inside ``shard_map``).

Bring-up: :func:`initialize_model_parallel` starts the default process
group when none exists, on the card with NCCL unless the caller asks for
``device="cpu"`` (gloo); without CUDA and without ``device="cpu"`` it
raises. A caller that wants another backend (two gloo ranks on one card)
starts the default group itself first. A launcher's environment (``RANK``,
``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``, as ``torchrun`` and
``parallel.multiproc`` set them) gives the world; without one the
process is a world of one.
"""

import dataclasses
import itertools
import os
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from apex_tpu_torch.utils.platform import DeviceLike, resolve_device
from apex_tpu_torch.utils.tree import tree_map

DATA_AXIS = "data"
PIPE_AXIS = "pipe"
CONTEXT_AXIS = "context"
TENSOR_AXIS = "model"

MESH_AXIS_NAMES = (DATA_AXIS, PIPE_AXIS, CONTEXT_AXIS, TENSOR_AXIS)

_MESH: Optional["Mesh"] = None
_VIRTUAL_PIPELINE_MODEL_PARALLEL_WORLD_SIZE: Optional[int] = None
_VIRTUAL_PIPELINE_MODEL_PARALLEL_RANK: Optional[int] = None
_PIPELINE_MODEL_PARALLEL_SPLIT_RANK: Optional[int] = None


class ParallelStateError(RuntimeError):
    pass


@dataclasses.dataclass
class Mesh:
    """The ranks laid out as the JAX mesh lays out its devices, and this
    rank's place and groups in it.

    ``ranks``: int array (dp, pp, cp, tp) of global ranks; ``coords``:
    this rank's index on each axis (None outside the mesh); ``groups``:
    axis name -> this rank's ``ProcessGroup`` along it; ``subgroups``:
    the cache of :func:`axis_group`'s restricted groups."""

    ranks: np.ndarray
    coords: Optional[Tuple[int, ...]]
    groups: Dict[str, Any]
    subgroups: Dict[Any, Any] = dataclasses.field(default_factory=dict)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(MESH_AXIS_NAMES, self.ranks.shape))

    def members(self, axis: str) -> list:
        """This rank's line of global ranks along ``axis``, in axis
        order."""
        ax = MESH_AXIS_NAMES.index(axis)
        idx = list(self._coords())
        idx[ax] = slice(None)
        return [int(r) for r in self.ranks[tuple(idx)]]

    def _coords(self) -> Tuple[int, ...]:
        if self.coords is None:
            raise ParallelStateError(
                f"rank {dist.get_rank()} is not in the model-parallel mesh "
                f"of ranks {self.ranks.reshape(-1).tolist()}")
        return self.coords


def _lines(ranks: np.ndarray, ax: int):
    """Every line of ``ranks`` along axis ``ax``, the other axes' indices
    in C order: the groups of that axis."""
    moved = np.moveaxis(ranks, ax, -1)
    return [[int(r) for r in moved[idx]]
            for idx in itertools.product(*map(range, moved.shape[:-1]))]


def _new_groups(lines):
    """``new_group`` for every line, in order, on every rank (the call
    is collective); returns this rank's group, or None. A line over the
    whole world is the default group."""
    me, world = dist.get_rank(), dist.get_world_size()
    mine = None
    for line in lines:
        g = dist.group.WORLD if sorted(line) == list(range(world)) \
            else dist.new_group(line)
        if me in line:
            mine = g
    return mine


def _bring_up(device: DeviceLike) -> None:
    """Start the default process group: NCCL on the card, gloo for
    ``device="cpu"``; from a launcher's environment, else a world of
    one."""
    dev = resolve_device(device)
    if dist.is_initialized():
        return
    backend = "nccl" if dev.type == "cuda" else "gloo"
    launched = "RANK" in os.environ and "WORLD_SIZE" in os.environ
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK", os.environ.get("RANK", 0))
                    if launched else 0)
        torch.cuda.set_device(local % torch.cuda.device_count())
    if launched:
        dist.init_process_group(backend, init_method="env://")
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)


def initialize_model_parallel(
    tensor_model_parallel_size_: int = 1,
    pipeline_model_parallel_size_: int = 1,
    virtual_pipeline_model_parallel_size_: Optional[int] = None,
    pipeline_model_parallel_split_rank_: Optional[int] = None,
    *,
    context_parallel_size_: int = 1,
    data_parallel_size_: Optional[int] = None,
    devices: Optional[Sequence[int]] = None,
    device: DeviceLike = None,
) -> Mesh:
    """Build and register the mesh of process groups (the reference's
    signature; data-parallel size ``world // (tp * pp * cp)``).
    ``devices``: the global ranks that form the mesh, in mesh order (all
    ranks by default); every rank must call this, members or not.
    ``device`` brings up the default process group when none exists
    (the module docstring). Returns the mesh."""
    global _MESH
    global _VIRTUAL_PIPELINE_MODEL_PARALLEL_WORLD_SIZE
    global _PIPELINE_MODEL_PARALLEL_SPLIT_RANK

    _bring_up(device)
    world_ranks = list(range(dist.get_world_size()))
    ranks = world_ranks if devices is None else [int(r) for r in devices]
    if len(set(ranks)) != len(ranks) or not set(ranks) <= set(world_ranks):
        raise ParallelStateError(
            f"devices {ranks} must be distinct ranks of the world "
            f"{world_ranks}")
    world = len(ranks)
    tp = int(tensor_model_parallel_size_)
    pp = int(pipeline_model_parallel_size_)
    cp = int(context_parallel_size_)
    denom = tp * pp * cp
    if denom <= 0 or world % denom != 0:
        raise ParallelStateError(
            f"world size {world} not divisible by tp*pp*cp = {tp}*{pp}*{cp}"
        )
    dp = world // denom
    if data_parallel_size_ is not None and dp != int(data_parallel_size_):
        raise ParallelStateError(
            f"requested data_parallel_size {data_parallel_size_} but world "
            f"{world} with tp*pp*cp = {tp}*{pp}*{cp} gives dp = {dp}"
        )
    if virtual_pipeline_model_parallel_size_ is not None and pp < 2:
        raise ParallelStateError(
            "virtual pipeline parallelism requires pipeline_model_parallel_size >= 2"
        )

    layout = np.asarray(ranks, dtype=np.int64).reshape(dp, pp, cp, tp)
    me = dist.get_rank()
    at = np.argwhere(layout == me)
    coords = tuple(int(c) for c in at[0]) if len(at) else None
    groups = {axis: _new_groups(_lines(layout, ax))
              for ax, axis in enumerate(MESH_AXIS_NAMES)}
    _MESH = Mesh(layout, coords, groups)
    _VIRTUAL_PIPELINE_MODEL_PARALLEL_WORLD_SIZE = (
        virtual_pipeline_model_parallel_size_
    )
    set_virtual_pipeline_model_parallel_rank(
        0 if virtual_pipeline_model_parallel_size_ is not None else None
    )
    _PIPELINE_MODEL_PARALLEL_SPLIT_RANK = pipeline_model_parallel_split_rank_
    return _MESH


def model_parallel_is_initialized() -> bool:
    return _MESH is not None


def destroy_model_parallel() -> None:
    """Forget the mesh and its groups (ref: ``destroy_model_parallel``);
    the default process group stays up."""
    global _MESH, _VIRTUAL_PIPELINE_MODEL_PARALLEL_WORLD_SIZE
    global _VIRTUAL_PIPELINE_MODEL_PARALLEL_RANK
    global _PIPELINE_MODEL_PARALLEL_SPLIT_RANK
    _MESH = None
    _VIRTUAL_PIPELINE_MODEL_PARALLEL_WORLD_SIZE = None
    _VIRTUAL_PIPELINE_MODEL_PARALLEL_RANK = None
    _PIPELINE_MODEL_PARALLEL_SPLIT_RANK = None


def get_mesh() -> Mesh:
    if _MESH is None:
        # lazy default, as the JAX package's: pure data parallelism over
        # the world, on the card
        initialize_model_parallel()
    return _MESH


def axis_group(axis_name: Any, axis_index_groups=None):
    """``(group, size)`` for a collective over ``axis_name``: a mesh axis
    name (this rank's group along it), or a ``ProcessGroup`` as it is.
    ``axis_index_groups`` (lists of axis indices partitioning the axis,
    as ``lax.psum`` takes them) restricts it to this rank's subgroup;
    those groups are created on every rank at first use and cached."""
    if not isinstance(axis_name, str):
        if axis_index_groups is not None:
            raise ValueError("axis_index_groups split a mesh axis; a "
                             "ProcessGroup is taken as it is")
        return axis_name, dist.get_world_size(axis_name)
    if axis_name not in MESH_AXIS_NAMES:
        raise ParallelStateError(f"unknown mesh axis {axis_name!r}; the "
                                 f"axes are {MESH_AXIS_NAMES}")
    mesh = get_mesh()
    if axis_index_groups is None:
        return mesh.groups[axis_name], mesh.shape[axis_name]
    parts = tuple(tuple(int(i) for i in g) for g in axis_index_groups)
    n = mesh.shape[axis_name]
    if sorted(i for g in parts for i in g) != list(range(n)) \
            or len({len(g) for g in parts}) != 1:
        raise ValueError(f"axis_index_groups {list(map(list, parts))} must "
                         f"split the {axis_name!r} axis's {n} indices into "
                         "groups of one size")
    key = (axis_name, parts)
    if key not in mesh.subgroups:
        ax = MESH_AXIS_NAMES.index(axis_name)
        mesh.subgroups[key] = _new_groups(
            [[line[i] for i in g] for line in _lines(mesh.ranks, ax)
             for g in parts])
    return mesh.subgroups[key], len(parts[0])


class PartitionSpec(tuple):
    """``jax.sharding.PartitionSpec``'s spelling for :func:`shard_map`:
    entry i names the mesh axis (or a tuple of axes, the first the
    major) that dimension i is split over, None a whole dimension;
    ``PartitionSpec()`` passes a value whole."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self):
        return f"PartitionSpec{tuple(self)!r}"


def _spec_dims(spec):
    """``[(dim, (axis, ...)), ...]`` for each dimension a spec splits; an
    unknown axis name raises."""
    out = []
    for dim, entry in enumerate(tuple(spec) if spec is not None else ()):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        for ax in axes:
            if ax not in MESH_AXIS_NAMES:
                raise ParallelStateError(
                    f"unknown mesh axis {ax!r} in spec {tuple(spec)}; the "
                    f"axes are {MESH_AXIS_NAMES}")
        out.append((dim, axes))
    return out


def _is_spec(x) -> bool:
    return x is None or isinstance(x, PartitionSpec)


def _map_specs(fn, specs, tree):
    """``fn(leaf, spec)`` over ``tree``, ``specs`` a prefix of it (as
    ``jax.shard_map`` reads ``in_specs`` and ``out_specs``): a spec (or
    None) stands for every leaf below it; dicts must have the same
    keys, sequences the same length. Returns a tree like ``tree``."""
    if _is_spec(specs):
        return tree_map(lambda x: fn(x, specs), tree)
    if isinstance(specs, dict):
        if not isinstance(tree, dict) or set(specs) != set(tree):
            got = sorted(tree) if isinstance(tree, dict) \
                else type(tree).__name__
            raise ValueError(f"spec keys {sorted(specs)} do not match the "
                             f"value's {got}")
        return {k: _map_specs(fn, specs[k], v) for k, v in tree.items()}
    if isinstance(specs, (list, tuple)) and isinstance(tree, (list, tuple)):
        if len(specs) != len(tree):
            raise ValueError(f"{len(specs)} specs for {len(tree)} values")
        items = [_map_specs(fn, s, v) for s, v in zip(specs, tree)]
        return type(tree)(*items) if hasattr(tree, "_fields") \
            else type(tree)(items)
    raise ValueError(f"spec {specs!r} does not match a value of type "
                     f"{type(tree).__name__}")


def _axis_index_and_size(mesh: Mesh, axes) -> Tuple[int, int]:
    """This rank's block index over ``axes`` (the first the major) and
    their number of blocks."""
    coords = mesh._coords()
    idx, n = 0, 1
    for ax in axes:
        size = mesh.shape[ax]
        idx = idx * size + coords[MESH_AXIS_NAMES.index(ax)]
        n *= size
    return idx, n


def shard_leaf(x: torch.Tensor, spec, mesh: Optional[Mesh] = None
               ) -> torch.Tensor:
    """This rank's block of ``x`` under ``spec``: every dimension the
    spec names is cut into as many blocks as its axes have ranks, and
    the block at this rank's index on them is kept (a contiguous
    copy; ``x`` itself where nothing is cut)."""
    mesh = mesh or get_mesh()
    out = x
    for dim, axes in _spec_dims(spec):
        idx, n = _axis_index_and_size(mesh, axes)
        if n == 1:
            continue
        if out.shape[dim] % n:
            raise ValueError(f"dimension {dim} of size {out.shape[dim]} "
                             f"does not split over {n} ranks of {axes}")
        size = out.shape[dim] // n
        out = out.narrow(dim, idx * size, size)
    return out if out is x else out.contiguous()


def gather_leaf(x: torch.Tensor, spec, mesh: Optional[Mesh] = None
                ) -> torch.Tensor:
    """The whole value from each rank's block ``x`` under ``spec``:
    every dimension the spec names is all-gathered over its axes'
    groups, the blocks in mesh order (the minor axis first)."""
    from apex_tpu_torch.transformer.tensor_parallel.mappings import (
        collective,
    )

    mesh = mesh or get_mesh()
    out = x
    for dim, axes in _spec_dims(spec):
        for ax in reversed(axes):
            if mesh.shape[ax] > 1:
                out = collective("all_gather", out, mesh.groups[ax],
                                 mesh.members(ax), dim=dim)
    return out


def shard_map(f, *, mesh: Optional[Mesh] = None, in_specs, out_specs,
              **kwargs):
    """Run ``f`` on this rank's shard, as ``jax.shard_map`` runs it on
    each device. ``in_specs`` is a prefix of the arguments' tuple and
    ``out_specs`` of the result, as JAX reads them: a spec tree mirrors
    its value, a single spec covers every leaf below it. Inputs are cut
    by :func:`shard_leaf` (any of the four axes on any dimension: a
    ``pipe``-sharded stage stack arrives as this stage's ``(1, ...)``
    slice, a ``context``-sharded sequence as this rank's block;
    ``PartitionSpec()`` whole); outputs with a named axis are
    all-gathered by :func:`gather_leaf`, in mesh order, and
    ``PartitionSpec()`` outputs are this rank's own. The JAX wrapper's ``check_vma`` /
    ``check_rep`` have no meaning in processes and are accepted as they
    are."""
    unknown = set(kwargs) - {"check_vma", "check_rep"}
    if unknown:
        raise TypeError(f"shard_map got unexpected arguments {sorted(unknown)}")
    tree_map(_spec_dims, (in_specs, out_specs), is_leaf=_is_spec)

    def run(*args):
        m = mesh or get_mesh()
        local = _map_specs(lambda x, s: shard_leaf(x, s, m), in_specs,
                          tuple(args))
        out = f(*local)
        return _map_specs(lambda x, s: gather_leaf(x, s, m), out_specs, out)

    return run


# ---------------------------------------------------------------------------
# Groups: this rank's ProcessGroup along each axis (the apex meaning).
# ---------------------------------------------------------------------------

def _group(axis: str):
    mesh = get_mesh()
    mesh._coords()
    return mesh.groups[axis]


def get_tensor_model_parallel_group():
    return _group(TENSOR_AXIS)


def get_pipeline_model_parallel_group():
    return _group(PIPE_AXIS)


def get_data_parallel_group():
    return _group(DATA_AXIS)


def get_context_parallel_group():
    return _group(CONTEXT_AXIS)


def get_embedding_group():
    # the reference's {first, last} pipeline stage group; as in the JAX
    # package (which returns the pipe axis's name), the pipe axis's
    # group: the pipeline schedules sum the embed and head gradients
    # over it, every stage holding the whole sum
    return _group(PIPE_AXIS)


# ---------------------------------------------------------------------------
# World sizes.
# ---------------------------------------------------------------------------

def _axis_size(name: str) -> int:
    return get_mesh().shape[name]


def get_tensor_model_parallel_world_size() -> int:
    return _axis_size(TENSOR_AXIS)


def get_pipeline_model_parallel_world_size() -> int:
    return _axis_size(PIPE_AXIS)


def get_data_parallel_world_size() -> int:
    return _axis_size(DATA_AXIS)


def get_context_parallel_world_size() -> int:
    return _axis_size(CONTEXT_AXIS)


def get_virtual_pipeline_model_parallel_world_size() -> Optional[int]:
    return _VIRTUAL_PIPELINE_MODEL_PARALLEL_WORLD_SIZE


def get_pipeline_model_parallel_split_rank() -> Optional[int]:
    return _PIPELINE_MODEL_PARALLEL_SPLIT_RANK


# ---------------------------------------------------------------------------
# Ranks: this rank's index along each axis.
# ---------------------------------------------------------------------------

def _axis_rank(name: str) -> int:
    return get_mesh()._coords()[MESH_AXIS_NAMES.index(name)]


def get_tensor_model_parallel_rank() -> int:
    return _axis_rank(TENSOR_AXIS)


def get_pipeline_model_parallel_rank() -> int:
    return _axis_rank(PIPE_AXIS)


def get_data_parallel_rank() -> int:
    return _axis_rank(DATA_AXIS)


def get_context_parallel_rank() -> int:
    return _axis_rank(CONTEXT_AXIS)


def get_virtual_pipeline_model_parallel_rank() -> Optional[int]:
    return _VIRTUAL_PIPELINE_MODEL_PARALLEL_RANK


def set_virtual_pipeline_model_parallel_rank(rank: Optional[int]) -> None:
    global _VIRTUAL_PIPELINE_MODEL_PARALLEL_RANK
    _VIRTUAL_PIPELINE_MODEL_PARALLEL_RANK = rank


def get_tensor_model_parallel_src_rank() -> int:
    """Index-0 position along the TP axis (broadcast source)."""
    return 0


def get_data_parallel_src_rank() -> int:
    return 0


def get_pipeline_model_parallel_first_rank() -> int:
    return 0


def get_pipeline_model_parallel_last_rank() -> int:
    return get_pipeline_model_parallel_world_size() - 1


def get_pipeline_model_parallel_next_rank() -> int:
    pp = get_pipeline_model_parallel_world_size()
    return (get_pipeline_model_parallel_rank() + 1) % pp


def get_pipeline_model_parallel_prev_rank() -> int:
    pp = get_pipeline_model_parallel_world_size()
    return (get_pipeline_model_parallel_rank() - 1) % pp


def is_pipeline_first_stage(ignore_virtual: bool = False) -> bool:
    """True on the first pipeline stage; with interleaving, only virtual
    rank 0 on pipe rank 0 is first."""
    if not ignore_virtual:
        vpp = _VIRTUAL_PIPELINE_MODEL_PARALLEL_WORLD_SIZE
        if vpp is not None and (_VIRTUAL_PIPELINE_MODEL_PARALLEL_RANK or 0) != 0:
            return False
    return get_pipeline_model_parallel_rank() == 0


def is_pipeline_last_stage(ignore_virtual: bool = False) -> bool:
    if not ignore_virtual:
        vpp = _VIRTUAL_PIPELINE_MODEL_PARALLEL_WORLD_SIZE
        if vpp is not None and (
            (_VIRTUAL_PIPELINE_MODEL_PARALLEL_RANK or 0) != vpp - 1
        ):
            return False
    return (
        get_pipeline_model_parallel_rank()
        == get_pipeline_model_parallel_world_size() - 1
    )


def get_model_parallel_world_size() -> int:
    """Tensor-parallel world size (the reference keeps it for Megatron;
    valid when pp == 1)."""
    return get_tensor_model_parallel_world_size()


def get_model_parallel_rank() -> int:
    return get_tensor_model_parallel_rank()

"""Tensor- and sequence-parallel region mappings, the collective
autograd pairs (counterpart of
``apex_tpu/transformer/tensor_parallel/mappings.py``; reference:
``apex/transformer/tensor_parallel/mappings.py``).

Each mapping is a ``torch.autograd.Function`` over this rank's ``model``
group (``parallel_state.get_tensor_model_parallel_group()``), its forward
and backward the JAX package's ``custom_vjp`` pair:

=============================================  ==============  ==============
mapping                                         forward         backward
=============================================  ==============  ==============
``copy_to_tensor_model_parallel_region``        identity        all-reduce
``reduce_from_tensor_model_parallel_region``    all-reduce      identity
``scatter_to_tensor_model_parallel_region``     split last dim  all-gather
``gather_from_tensor_model_parallel_region``    all-gather      split
``scatter_to_sequence_parallel_region``         split seq dim   all-gather
``gather_from_sequence_parallel_region``        all-gather seq  reduce-scatter
``reduce_scatter_to_sequence_parallel_region``  reduce-scatter  all-gather
=============================================  ==============  ==============

The sequence dimension is ``seq_dim`` (0 by default, Megatron's (s, b,
h); GPT's (b, s, h) passes 1). A rank's block of a split dimension is the
one at its index along the ``model`` axis, and gathers concatenate the
blocks in that order. On a ``model`` axis of one rank every mapping is
the identity.

Every collective goes through :func:`collective`: on an NCCL group the
in-place ``torch.distributed`` call on the device; on a gloo group a
CUDA tensor is copied to the host, reduced or gathered there, and copied
back (gloo's collectives take host tensors; two ranks on one card must
use gloo, since NCCL refuses them). The bytes so staged, both ways, add
to :data:`staged_bytes`. Two more kinds serve the pipeline and context
axes: a ring ``"shift"`` (``lax.ppermute`` by one step along the axis
order) and a tiled ``"all_to_all"``; :func:`shift` and
:func:`all_to_all` are their autograd forms, each with its inverse as
the backward (the reverse shift; the all-to-all with the two axes
swapped), as JAX transposes ``ppermute`` and ``all_to_all``.
"""

import torch
import torch.distributed as dist

from apex_tpu_torch.transformer import parallel_state as ps

# bytes copied device -> host and host -> device by gloo collectives on
# CUDA tensors (a plain int; set it to 0 before a run, read it after)
staged_bytes = 0

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def _staged(x: torch.Tensor, group) -> bool:
    """True when ``group``'s backend cannot take ``x`` where it lies: a
    CUDA tensor on a gloo group."""
    return x.is_cuda and dist.get_backend(group) == "gloo"


def collective(kind: str, x: torch.Tensor, group, members, *, dim: int = 0,
               op: str = "sum", src: int = 0, step: int = 1,
               concat_dim: int = 0) -> torch.Tensor:
    """One collective over ``group`` whose ranks, in axis order, are the
    global ranks ``members``; returns a new tensor (``x`` is not
    changed):

    - ``"all_reduce"``: the ``op`` ("sum" or "max") over the group;
    - ``"all_gather"``: the members' ``x`` concatenated along ``dim`` in
      axis order;
    - ``"reduce_scatter"``: the sum over the group of ``x``, this
      rank's block along ``dim`` (block i to the member at axis index
      i);
    - ``"broadcast"``: the ``x`` of the member at axis index ``src``;
    - ``"shift"``: the ``x`` of the member ``step`` places before this
      one in axis order, cyclically (this rank's ``x`` goes ``step``
      places on): one ``isend`` and one ``irecv``, both waited on, so
      every rank posts the same exchange; a group of one rank gives
      ``x`` and posts nothing;
    - ``"all_to_all"``: ``x`` cut into ``n`` blocks along ``dim``, block
      i to the member at axis index i, the blocks received concatenated
      along ``concat_dim`` in axis order (``lax.all_to_all(...,
      tiled=True)``).

    A CUDA tensor on a gloo group is staged through host memory (counted
    in :data:`staged_bytes`)."""
    global staged_bytes
    n = len(members)
    if kind == "shift" and n == 1:
        return x.detach().clone()
    # the group's ranks are the members sorted; slot j of a collective's
    # list is the member at axis index order[j]
    order = [members.index(r) for r in sorted(members)]
    dev = x.device
    staged = _staged(x, group)
    t = x.detach().contiguous()
    if staged:
        t = t.cpu()
        staged_bytes += t.numel() * t.element_size()
    if kind == "all_reduce":
        out = t.clone()
        dist.all_reduce(out, op=_OPS[op], group=group)
    elif kind == "broadcast":
        out = t.clone()
        dist.broadcast(out, src=members[src], group=group)
    elif kind == "all_gather":
        # the members' tensors end to end along dim 0 (gloo's layout;
        # NCCL takes it too), then in axis order along ``dim``
        buf = t.new_empty((n * t.shape[0],) + tuple(t.shape[1:]))
        dist.all_gather_into_tensor(buf, t, group=group)
        parts = [None] * n
        for j, i in enumerate(order):
            parts[i] = buf.narrow(0, j * t.shape[0], t.shape[0])
        out = torch.cat(parts, dim=dim)
    elif kind == "reduce_scatter":
        if t.shape[dim] % n:
            raise ValueError(f"dimension {dim} of size {t.shape[dim]} does "
                             f"not split over {n} ranks")
        blocks = t.chunk(n, dim=dim)
        buf = torch.cat([blocks[i] for i in order])
        out = t.new_empty(blocks[0].shape)
        dist.reduce_scatter_tensor(out, buf, group=group)
    elif kind == "shift":
        me = members.index(dist.get_rank())
        out = torch.empty_like(t)
        reqs = [dist.isend(t, members[(me + step) % n], group=group),
                dist.irecv(out, members[(me - step) % n], group=group)]
        for req in reqs:
            req.wait()
    elif kind == "all_to_all":
        if t.shape[dim] % n:
            raise ValueError(f"dimension {dim} of size {t.shape[dim]} does "
                             f"not split over {n} ranks")
        blocks = t.chunk(n, dim=dim)
        send = torch.stack([blocks[i] for i in order])
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=group)
        parts = [None] * n
        for j, i in enumerate(order):
            parts[i] = recv[j]
        out = torch.cat(parts, dim=concat_dim)
    else:
        raise ValueError(f"unknown collective {kind!r}")
    if staged:
        staged_bytes += out.numel() * out.element_size()
        out = out.to(dev)
    return out


def _tp():
    """(group, members, this rank's index) of the ``model`` axis."""
    mesh = ps.get_mesh()
    members = mesh.members(ps.TENSOR_AXIS)
    return (ps.get_tensor_model_parallel_group(), members,
            ps.get_tensor_model_parallel_rank())


def _tp_size() -> int:
    return ps.get_tensor_model_parallel_world_size()


def _all_reduce(x, op="sum"):
    group, members, _ = _tp()
    return collective("all_reduce", x, group, members, op=op)


def _split_along(x, dim):
    """This rank's block of ``dim`` (ref: ``_split_along_last_dim``)."""
    n = _tp_size()
    if x.shape[dim] % n:
        raise ValueError(f"dimension {dim} of size {x.shape[dim]} does not "
                         f"split over {n} tensor-parallel ranks")
    size = x.shape[dim] // n
    return x.narrow(dim, ps.get_tensor_model_parallel_rank() * size,
                    size).contiguous()


def _gather_along(x, dim):
    group, members, _ = _tp()
    return collective("all_gather", x, group, members, dim=dim % x.dim())


def _reduce_scatter_along(x, dim):
    group, members, _ = _tp()
    return collective("reduce_scatter", x, group, members, dim=dim % x.dim())


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g)


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _all_reduce(x)

    @staticmethod
    def backward(ctx, g):
        return g


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim):
        ctx.dim = dim
        return _split_along(x, dim)

    @staticmethod
    def backward(ctx, g):
        return _gather_along(g, ctx.dim), None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, to_model_parallel):
        ctx.dim, ctx.to_model_parallel = dim, to_model_parallel
        return _gather_along(x, dim)

    @staticmethod
    def backward(ctx, g):
        # entering a TP region the dual sums every rank's gradient
        # (reduce-scatter); leaving to a pure SP consumer it splits
        if ctx.to_model_parallel:
            return _reduce_scatter_along(g, ctx.dim), None, None
        return _split_along(g, ctx.dim), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim):
        ctx.dim = dim
        return _reduce_scatter_along(x, dim)

    @staticmethod
    def backward(ctx, g):
        return _gather_along(g, ctx.dim), None


def copy_to_tensor_model_parallel_region(x):
    """Identity forward, all-reduce of the gradient backward."""
    return x if _tp_size() == 1 else _Copy.apply(x)


def reduce_from_tensor_model_parallel_region(x):
    """All-reduce forward, identity backward."""
    return x if _tp_size() == 1 else _Reduce.apply(x)


def scatter_to_tensor_model_parallel_region(x):
    """This rank's block of the last dimension; all-gather backward."""
    return x if _tp_size() == 1 else _Scatter.apply(x, -1)


def gather_from_tensor_model_parallel_region(x):
    """All-gather of the last dimension; split backward."""
    return x if _tp_size() == 1 else _Gather.apply(x, -1, False)


def scatter_to_sequence_parallel_region(x, seq_dim: int = 0):
    """This rank's block of the sequence dimension; all-gather
    backward."""
    return x if _tp_size() == 1 else _Scatter.apply(x, seq_dim)


def gather_from_sequence_parallel_region(x, to_model_parallel: bool = True,
                                         seq_dim: int = 0):
    """All-gather of the sequence dimension; backward a reduce-scatter
    (``to_model_parallel``) or a split."""
    return x if _tp_size() == 1 else _Gather.apply(x, seq_dim,
                                                   to_model_parallel)


def reduce_scatter_to_sequence_parallel_region(x, seq_dim: int = 0):
    """Reduce-scatter of the sequence dimension; all-gather backward."""
    return x if _tp_size() == 1 else _ReduceScatter.apply(x, seq_dim)


# ---------------------------------------------------------------------------
# the pipeline and context axes: ring shifts and all-to-alls over any axis
# ---------------------------------------------------------------------------

def _axis(axis: str):
    """(group, members) of this rank's line along a mesh axis."""
    mesh = ps.get_mesh()
    return mesh.groups[axis], mesh.members(axis)


class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, step):
        ctx.axis, ctx.step = axis, step
        group, members = _axis(axis)
        return collective("shift", x, group, members, step=step)

    @staticmethod
    def backward(ctx, g):
        group, members = _axis(ctx.axis)
        return collective("shift", g, group, members, step=-ctx.step), \
            None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, split_dim, concat_dim):
        ctx.axis, ctx.dims = axis, (split_dim, concat_dim)
        group, members = _axis(axis)
        return collective("all_to_all", x, group, members, dim=split_dim,
                          concat_dim=concat_dim)

    @staticmethod
    def backward(ctx, g):
        split_dim, concat_dim = ctx.dims
        group, members = _axis(ctx.axis)
        return collective("all_to_all", g, group, members, dim=concat_dim,
                          concat_dim=split_dim), None, None, None


def shift(x: torch.Tensor, axis: str, step: int) -> torch.Tensor:
    """``lax.ppermute`` of ``x`` by ``step`` places along the mesh axis
    ``axis`` (rank i's ``x`` to rank ``i + step``, cyclically); the
    backward shifts the gradient back by ``-step``. The identity on an
    axis of one rank."""
    if ps.get_mesh().shape[axis] == 1:
        return x
    return _Shift.apply(x, axis, step)


def all_to_all(x: torch.Tensor, axis: str, split_dim: int,
               concat_dim: int) -> torch.Tensor:
    """``lax.all_to_all(x, axis, split_dim, concat_dim, tiled=True)``;
    the backward is the all-to-all with the two dimensions swapped. The
    identity on an axis of one rank."""
    if ps.get_mesh().shape[axis] == 1:
        return x
    split_dim, concat_dim = split_dim % x.dim(), concat_dim % x.dim()
    return _AllToAll.apply(x, axis, split_dim, concat_dim)

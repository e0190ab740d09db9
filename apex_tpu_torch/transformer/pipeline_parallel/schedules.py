"""Pipeline-parallel schedules over the ``pipe`` axis (counterpart of
``apex_tpu/transformer/pipeline_parallel/schedules.py``; reference:
``apex/transformer/pipeline_parallel/schedules/__init__.py ::
get_forward_backward_func`` with ``fwd_bwd_no_pipelining.py``,
``fwd_bwd_pipelining_without_interleaving.py`` (1F1B) and
``fwd_bwd_pipelining_with_interleaving.py``).

Each rank is its stage and runs the JAX package's tick loop eagerly:

- the stage parameters arrive as this stage's slice of the stacked
  ``(pp, ...)`` stage leaves (``(vpp, 1, ...)`` with interleaving), as
  ``parallel_state.shard_map`` cuts them with ``P(PIPE_AXIS)``;
- the plain schedule runs ``M + 2(pp-1)`` ticks; tick ``t`` forwards
  microbatch ``t - d`` on stage ``d`` and backwards microbatch
  ``t - 2(pp-1) + d``, so the last stage seeds each microbatch's
  backward from its loss in the tick that forwards it (1F1B's steady
  state); the interleaved one runs ``M + 2(pp*vpp - 1)`` ticks over
  ``vpp`` lanes, chunk ``c`` on rank ``c % pp`` in lane ``c // pp``;
- after every tick the activations shift +1 and the gradients -1 along
  the ``pipe`` group (``p2p_communication``), on every rank, so every
  rank posts the same exchanges in the same order; under interleaving
  the first stage rolls its received lanes by one (a chunk boundary
  wraps from the last stage back to the first) and the last stage its
  received gradients by minus one;
- the forward runs without a graph and keeps the stage's input in a
  ring of ``2pp - 1`` slots (``2 pp vpp - 1`` a lane); the backward
  recomputes the stage from that input with autograd and frees the
  slot, so no graph lives across ticks and the live activations are
  O(pp x microbatch), independent of M (``peak_saved_inputs`` counts
  the slots held);
- a bubble tick skips its compute (each rank is its own process, so no
  SPMD program needs the masked work the JAX scan does) but still posts
  its exchanges, of zeros;
- gradients and losses accumulate in fp32; the loss is the mean of the
  microbatch means (each microbatch's backward seeded with ``1/M``);
  the embed and head gradients are summed over the ``pipe`` group, so
  every stage holds them whole (the reference's embedding-group
  all-reduce).

Model contract, the functional one of the JAX package::

    model = PipelineModel(embed_fn, stage_fn, loss_fn)
    params = {"embed": ..., "stages": <leaves stacked on a stage axis>,
              "head": ...}

- ``embed_fn(embed_params, microbatch) -> hidden``, the first stage's
  input;
- ``stage_fn(one_stage_params, hidden) -> hidden``, the stages' body;
- ``loss_fn(head_params, hidden, microbatch) -> scalar``, on the last.

Call the pipelined schedules inside ``parallel_state.shard_map`` with
``P(PIPE_AXIS)`` on the stage leaves (interleaved: ``(vpp, pp, ...)``
leaves with ``P(None, PIPE_AXIS)``) and the embed, head and batch whole.
The returned gradients have the local structure of ``params``.
"""

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from apex_tpu_torch.transformer import parallel_state as ps
from apex_tpu_torch.transformer.pipeline_parallel import \
    microbatches as mb_calc
from apex_tpu_torch.transformer.pipeline_parallel.p2p_communication import (
    send_backward_recv_backward,
    send_forward_recv_forward,
)
from apex_tpu_torch.transformer.tensor_parallel.mappings import collective
from apex_tpu_torch.utils.tree import tree_leaves, tree_map

Pytree = Any

# the most stage inputs the last pipelined run held at once on this rank
# (a plain int, set by each run of the two pipelined schedules)
peak_saved_inputs = 0


@dataclasses.dataclass(frozen=True)
class PipelineModel:
    embed_fn: Callable[[Pytree, Pytree], torch.Tensor]
    stage_fn: Callable[[Pytree, torch.Tensor], torch.Tensor]
    loss_fn: Callable[[Pytree, torch.Tensor, Pytree], torch.Tensor]


def split_batch_into_microbatches(batch: Pytree,
                                  num_microbatches: int) -> Pytree:
    """(B, ...) leaves -> (M, B//M, ...) (ref: the schedules' batch
    iterator; a reshape, as in the JAX package)."""
    def split(a):
        b = a.shape[0]
        if b % num_microbatches:
            raise ValueError(
                f"batch dim {b} not divisible by {num_microbatches} "
                "microbatches")
        return a.reshape((num_microbatches, b // num_microbatches)
                         + tuple(a.shape[1:]))
    return tree_map(split, batch)


def _num_microbatches(num_microbatches: Optional[int]) -> int:
    if num_microbatches is not None:
        return int(num_microbatches)
    return mb_calc.get_num_microbatches()


def _mb_at(mbs: Pytree, i: int) -> Pytree:
    return tree_map(lambda a: a[i], mbs)


def _unstack(tree: Pytree, n: int) -> List[Pytree]:
    """The n slices of a tree's leading axis, by one ``unbind`` a leaf
    (indexing one slice at a time would give each slice's gradient as a
    zero-filled stack)."""
    cols = tree_map(lambda a: a.unbind(0), tree)
    return [tree_map(lambda c: c[i], cols,
                     is_leaf=lambda x: isinstance(x, tuple)
                     and not hasattr(x, "_fields"))
            for i in range(n)]


def _vjp(fn: Callable, primals: List[Pytree], cot):
    """``jax.vjp`` over trees of tensors: ``(fn(*primals) detached, [the
    gradient of <fn(*primals), cot> for each primal tree])``; ``cot`` a
    tensor or a function of the output that gives it; integer leaves and
    leaves ``fn`` does not reach get zeros."""
    req = [tree_map(lambda a: a.detach().requires_grad_(
        a.is_floating_point()), p) for p in primals]
    with torch.enable_grad():
        out = fn(*req)
    if callable(cot):
        cot = cot(out)
    need = [leaf for p in req for leaf in tree_leaves(p)
            if leaf.requires_grad]
    got = {}
    if need and out.requires_grad:
        got = {id(leaf): g for leaf, g in zip(need, torch.autograd.grad(
            out, need, cot, allow_unused=True)) if g is not None}

    def grad_of(leaf):
        g = got.get(id(leaf))
        return torch.zeros_like(leaf) if g is None else g

    return out.detach(), [tree_map(grad_of, p) for p in req]


def _acc_dtype(a: torch.Tensor) -> torch.dtype:
    return torch.promote_types(a.dtype, torch.float32)


def _zeros_f32_like(tree: Pytree) -> Pytree:
    return tree_map(lambda a: torch.zeros(a.shape, dtype=_acc_dtype(a),
                                          device=a.device), tree)


def _accumulate(acc: Pytree, upd: Pytree) -> None:
    tree_map(lambda a, b: a.add_(b.to(a.dtype)), acc, upd)


def _psum_pipe(tree: Pytree) -> Pytree:
    """Every leaf summed over this rank's ``pipe`` group."""
    if ps.get_pipeline_model_parallel_world_size() == 1:
        return tree
    mesh = ps.get_mesh()
    group, members = mesh.groups[ps.PIPE_AXIS], mesh.members(ps.PIPE_AXIS)
    return tree_map(lambda a: collective("all_reduce", a, group, members),
                    tree)


# ---------------------------------------------------------------------------
# no pipelining
# ---------------------------------------------------------------------------

def forward_backward_no_pipelining(
    model: PipelineModel,
    params: Dict[str, Pytree],
    batch: Pytree,
    *,
    num_microbatches: Optional[int] = None,
    forward_only: bool = False,
    checkpoint_stages: bool = True,
    fp32_grad_accum: bool = True,
) -> Tuple[torch.Tensor, Optional[Pytree]]:
    """Gradient accumulation over microbatches, no pipe exchange (ref:
    ``fwd_bwd_no_pipelining.py``); usable with or without a mesh. The
    stages run in order over the stage axis, each checkpointed under
    ``checkpoint_stages`` (recomputed in the backward).

    ``fp32_grad_accum`` is the ``gradient_accumulation_fusion``
    analogue: the accumulators are fp32 whatever the parameters' dtype,
    so M bf16 microbatch gradients keep their low bits as they sum
    (without it they accumulate in the parameters' dtype)."""
    M = _num_microbatches(num_microbatches)
    mbs = split_batch_into_microbatches(batch, M)
    n_stages = tree_leaves(params["stages"])[0].shape[0]

    def stage(sp, x):
        if checkpoint_stages and torch.is_grad_enabled():
            return checkpoint(model.stage_fn, sp, x, use_reentrant=False)
        return model.stage_fn(sp, x)

    def mb_loss(p, mb):
        x = model.embed_fn(p["embed"], mb)
        for sp in _unstack(p["stages"], n_stages):
            x = stage(sp, x)
        return model.loss_fn(p["head"], x, mb)

    if forward_only:
        with torch.no_grad():
            total = sum(mb_loss(params, _mb_at(mbs, i)).float()
                        for i in range(M))
        return total / M, None

    acc_dtype = _acc_dtype if fp32_grad_accum else (lambda a: a.dtype)
    grads = tree_map(lambda a: torch.zeros(a.shape, dtype=acc_dtype(a),
                                           device=a.device), params)
    total = None
    for i in range(M):
        mb = _mb_at(mbs, i)
        loss, (g,) = _vjp(lambda p: mb_loss(p, mb), [params],
                          torch.ones_like)
        _accumulate(grads, g)
        loss = loss.float()
        total = loss if total is None else total + loss
    return total / M, tree_map(lambda a: a / M, grads)


# ---------------------------------------------------------------------------
# plain (non-interleaved) pipelining: 1F1B
# ---------------------------------------------------------------------------

def _hidden_proto(model: PipelineModel, embed_p, mb0) -> torch.Tensor:
    """Zeros of the hidden's shape and dtype: what a bubble tick sends."""
    with torch.no_grad():
        return torch.zeros_like(model.embed_fn(embed_p, mb0))


def forward_backward_pipelining_without_interleaving(
    model: PipelineModel,
    params: Dict[str, Pytree],
    batch: Pytree,
    *,
    num_microbatches: Optional[int] = None,
    forward_only: bool = False,
    checkpoint_stages: bool = True,
) -> Tuple[torch.Tensor, Optional[Pytree]]:
    """1F1B (ref: ``fwd_bwd_pipelining_without_interleaving``); call
    inside shard_map, ``params["stages"]`` leaves this stage's ``(1,
    ...)`` slice of the ``(pp, ...)`` stack.

    Tick ``t`` forwards microbatch ``t - d`` and backwards microbatch
    ``t - 2(pp-1) + d`` on stage ``d``; the stage's inputs wait in a
    ring of ``2pp - 1`` slots and the backward recomputes the stage from
    its saved input (``checkpoint_stages`` is accepted for the
    reference's signature: the recompute is inherent)."""
    global peak_saved_inputs
    del checkpoint_stages
    M = _num_microbatches(num_microbatches)
    mbs = split_batch_into_microbatches(batch, M)
    pp = ps.get_pipeline_model_parallel_world_size()
    d = ps.get_pipeline_model_parallel_rank()
    first, last = d == 0, d == pp - 1
    stage_p = tree_map(lambda a: a[0], params["stages"])
    embed_p, head_p = params["embed"], params["head"]
    zeros = _hidden_proto(model, embed_p, _mb_at(mbs, 0))

    if forward_only:
        total = torch.zeros((), device=zeros.device)
        state = zeros
        with torch.no_grad():
            for t in range(M + pp - 1):
                y = zeros
                if 0 <= t - d < M:
                    x_in = model.embed_fn(embed_p, _mb_at(mbs, t)) \
                        if first else state
                    y = model.stage_fn(stage_p, x_in)
                    if last:
                        total += model.loss_fn(head_p, y,
                                               _mb_at(mbs, t - d)).float()
                state = send_forward_recv_forward(y)
        return _psum_pipe(total / M), None

    R = 2 * pp - 1          # the input ring: its most residents
    T = M + 2 * (pp - 1)    # fill, steady 1F1B, drain
    ring: List[Optional[torch.Tensor]] = [None] * R
    state = cot = zeros
    g_stage, g_embed, g_head = (_zeros_f32_like(stage_p),
                                _zeros_f32_like(embed_p),
                                _zeros_f32_like(head_p))
    loss_acc = torch.zeros((), device=zeros.device)
    held = 0
    for t in range(T):
        # forward half: stage d forwards microbatch t - d
        m_f = t - d
        y = zeros
        if 0 <= m_f < M:
            with torch.no_grad():
                x_in = model.embed_fn(embed_p, _mb_at(mbs, t)) \
                    if first else state
                y = model.stage_fn(stage_p, x_in)
            ring[m_f % R] = x_in
        held = max(held, sum(r is not None for r in ring))

        # loss half: the last stage seeds the backward from this tick's y
        m_l = t - (pp - 1)
        dy_loss = None
        if last and 0 <= m_l < M:
            loss, (dhead, dy_loss) = _loss_vjp(model, head_p, y,
                                               _mb_at(mbs, m_l), M)
            loss_acc += loss.float()
            _accumulate(g_head, dhead)

        # backward half: stage d backwards microbatch t - 2(pp-1) + d
        m_b = t - 2 * (pp - 1) + d
        dx = zeros
        if 0 <= m_b < M:
            slot = m_b % R
            x_saved, ring[slot] = ring[slot], None
            _, (dstage, dx) = _vjp(model.stage_fn, [stage_p, x_saved],
                                   dy_loss if last else cot)
            _accumulate(g_stage, dstage)
            if first:
                mb_b = _mb_at(mbs, m_b)
                _, (dembed,) = _vjp(lambda ep: model.embed_fn(ep, mb_b),
                                    [embed_p], dx)
                _accumulate(g_embed, dembed)

        state = send_forward_recv_forward(y)
        cot = send_backward_recv_backward(dx)
    peak_saved_inputs = held

    grads = {
        "stages": tree_map(lambda a: a[None], g_stage),
        # the embed gradients live on stage 0, the head's on the last:
        # both summed over pipe (the reference's embedding-group
        # all-reduce)
        "embed": _psum_pipe(g_embed),
        "head": _psum_pipe(g_head),
    }
    return _psum_pipe(loss_acc) / M, grads


def _loss_vjp(model: PipelineModel, head_p, y, mb, M: int):
    """``(loss, [d head, d y])`` of one microbatch's loss, seeded with
    ``1/M`` (the loss is the mean of the microbatch means)."""
    return _vjp(lambda hp, yy: model.loss_fn(hp, yy, mb), [head_p, y],
                lambda loss: torch.full((), 1.0 / M, dtype=loss.dtype,
                                        device=loss.device))


# ---------------------------------------------------------------------------
# interleaved (virtual pipeline): lanes of round-robin chunks
# ---------------------------------------------------------------------------

def forward_backward_pipelining_with_interleaving(
    model: PipelineModel,
    params: Dict[str, Pytree],
    batch: Pytree,
    *,
    num_microbatches: Optional[int] = None,
    forward_only: bool = False,
    checkpoint_stages: bool = True,
    virtual_pipeline_size: Optional[int] = None,
) -> Tuple[torch.Tensor, Optional[Pytree]]:
    """Interleaved schedule (ref: ``fwd_bwd_pipelining_with_interleaving``).

    Model chunk ``c`` (of ``pp*vpp``) lives on rank ``c % pp``, the
    reference's round-robin. ``params["stages"]`` leaves arrive as the
    local ``(vpp, 1, ...)`` slice of a ``(vpp, pp, ...)`` stack (``[l,
    dev]`` = chunk ``l*pp + dev``). Each rank keeps ``vpp`` lanes; lane
    ``l`` holds the microbatch entering chunk ``l*pp + d``. One shift a
    tick moves all lanes; the first stage rolls its received lanes by
    one, the last stage its received gradients by minus one."""
    global peak_saved_inputs
    vpp = virtual_pipeline_size or \
        ps.get_virtual_pipeline_model_parallel_world_size()
    if vpp is None or vpp < 1:
        raise ValueError("interleaved schedule requires a virtual "
                         "pipeline size (initialize_model_parallel("
                         "virtual_pipeline_model_parallel_size_=...))")
    del checkpoint_stages
    M = _num_microbatches(num_microbatches)
    mbs = split_batch_into_microbatches(batch, M)
    pp = ps.get_pipeline_model_parallel_world_size()
    d = ps.get_pipeline_model_parallel_rank()
    first, last = d == 0, d == pp - 1
    stage_ps = _unstack(tree_map(lambda a: a[:, 0], params["stages"]), vpp)
    embed_p, head_p = params["embed"], params["head"]
    n_chunks = pp * vpp
    chunk = [lane * pp + d for lane in range(vpp)]
    zeros = _hidden_proto(model, embed_p, _mb_at(mbs, 0))
    lanes = [zeros] * vpp

    def lane_input(t, lane):
        if lane == 0 and first:
            return model.embed_fn(embed_p, _mb_at(mbs, t))
        return lanes[lane]

    def rotate_fwd(ys):
        recv = send_forward_recv_forward(torch.stack(ys))
        if first:
            recv = torch.roll(recv, 1, dims=0)
        return list(recv.unbind(0))

    if forward_only:
        total = torch.zeros((), device=zeros.device)
        with torch.no_grad():
            for t in range(M + n_chunks - 1):
                ys = [model.stage_fn(stage_ps[lane], lane_input(t, lane))
                      if 0 <= t - chunk[lane] < M else zeros
                      for lane in range(vpp)]
                m_l = t - (n_chunks - 1)
                if last and 0 <= m_l < M:
                    total += model.loss_fn(head_p, ys[vpp - 1],
                                           _mb_at(mbs, m_l)).float()
                lanes = rotate_fwd(ys)
        return _psum_pipe(total / M), None

    R = 2 * n_chunks - 1
    T = M + 2 * (n_chunks - 1)
    rings = [[None] * R for _ in range(vpp)]
    cots = [zeros] * vpp
    g_stage = [_zeros_f32_like(sp) for sp in stage_ps]
    g_embed, g_head = _zeros_f32_like(embed_p), _zeros_f32_like(head_p)
    loss_acc = torch.zeros((), device=zeros.device)
    held = 0
    for t in range(T):
        # forward half: chunk c forwards microbatch t - c
        ys = []
        for lane in range(vpp):
            m_f = t - chunk[lane]
            y = zeros
            if 0 <= m_f < M:
                with torch.no_grad():
                    x_in = lane_input(t, lane)
                    y = model.stage_fn(stage_ps[lane], x_in)
                rings[lane][m_f % R] = x_in
            ys.append(y)
        held = max(held, sum(r is not None for ring in rings for r in ring))

        # loss half: chunk N-1, lane vpp-1 on the last stage
        m_l = t - (n_chunks - 1)
        dy_loss = None
        if last and 0 <= m_l < M:
            loss, (dhead, dy_loss) = _loss_vjp(model, head_p, ys[vpp - 1],
                                               _mb_at(mbs, m_l), M)
            loss_acc += loss.float()
            _accumulate(g_head, dhead)

        # backward half: chunk c backwards microbatch t - 2(N-1) + c
        dxs = []
        for lane in range(vpp):
            m_b = t - 2 * (n_chunks - 1) + chunk[lane]
            dx = zeros
            if 0 <= m_b < M:
                slot = m_b % R
                x_saved, rings[lane][slot] = rings[lane][slot], None
                g_in = dy_loss if (last and lane == vpp - 1) else cots[lane]
                _, (dstage, dx) = _vjp(model.stage_fn,
                                       [stage_ps[lane], x_saved], g_in)
                _accumulate(g_stage[lane], dstage)
                if first and lane == 0:
                    mb_b = _mb_at(mbs, m_b)
                    _, (dembed,) = _vjp(
                        lambda ep: model.embed_fn(ep, mb_b), [embed_p], dx)
                    _accumulate(g_embed, dembed)
            dxs.append(dx)

        # rotate: activations +1 with the first stage's lane roll; the
        # gradients -1 with the last stage's (chunk (l+1)*pp flows back
        # to chunk l*pp + pp-1)
        lanes = rotate_fwd(ys)
        cot_recv = send_backward_recv_backward(torch.stack(dxs))
        if last:
            cot_recv = torch.roll(cot_recv, -1, dims=0)
        cots = list(cot_recv.unbind(0))
    peak_saved_inputs = held

    grads = {
        "stages": tree_map(lambda *a: torch.stack(a)[:, None], *g_stage),
        "embed": _psum_pipe(g_embed),
        "head": _psum_pipe(g_head),
    }
    return _psum_pipe(loss_acc) / M, grads


# ---------------------------------------------------------------------------
# dispatcher
# ---------------------------------------------------------------------------

def get_forward_backward_func() -> Callable[..., Tuple[torch.Tensor,
                                                       Optional[Pytree]]]:
    """Pick the schedule from the global parallel state (ref:
    ``schedules/__init__.py :: get_forward_backward_func``)."""
    if ps.get_pipeline_model_parallel_world_size() == 1:
        return forward_backward_no_pipelining
    if ps.get_virtual_pipeline_model_parallel_world_size() is not None:
        return forward_backward_pipelining_with_interleaving
    return forward_backward_pipelining_without_interleaving

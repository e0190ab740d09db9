"""Port parity of ``apex_tpu_torch.parallel``, ``transformer.parallel_state``,
``contrib.groupbn``, the synced ``layers.batchnorm`` and the data-parallel
BERT step, against the JAX package on the CPU.

The JAX side runs in this process on ``jax.devices()[:W]`` (the rig's
virtual CPU devices) through ``ps.initialize_model_parallel`` and
``ps.shard_map``, as ``tests/L0/run_parallel/test_data_parallel.py``
does. The port side runs in W processes spawned with
``torch.multiprocessing`` on gloo (one thread each), which meet through
a file in the test's temporary directory (no TCP port, so parallel test
workers cannot clash). One spawn at W = 2 and one at W = 4 run every
port-side case; each rank saves its results, and the tests here compare
them. This module imports no JAX at its top: the spawned ranks import it
again. Inputs come from numpy seeds on both sides; weights trees cross
from JAX through ``params_from_jax``.

Tolerances. At W = 2 a sum of two values is the same in any order and
division by 2 is exact, so ``allreduce_grads`` (fp32, bf16 through
fp32, sums, bucketed or not) equals ``psum`` / ``psum(1)`` bit for bit,
``broadcast_params`` gives rank 0's bits, and the SyncBN running
statistics equal JAX's bit for bit on inputs whose sums are exact
(multiples of 1/8 in [-2, 2], 32 a channel a rank: each side's local
mean and mean of squares is then exact; read at momentum 1, since XLA
may contract the running update's multiply-add into one rounding). On random inputs the local
means sum in other orders on the two sides: statistics, outputs and
input gradients of SyncBN and groupbn are held within 1e-5 of the
largest magnitude of the compared array (fp32, a few dozen ulps of sums
over 32-128 terms). At W = 4 gloo's ring sums in another order than
XLA's: ``allreduce_grads`` is held to 4 ulps of the sum of |terms| (8
for the average, one more rounding). The ResNet-10 SyncBN step (fp32):
loss within 1e-5 relative, each gradient within 1e-4 in relative norm,
the new params within lr times that, statistics within 1e-5 of their
largest magnitude. The DDP example: losses within 1e-5 at O0 (at O2
the two frameworks round the bf16 products at different places, and the
losses part by about 1e-4 within three steps). ``bert_tiny``'s two DDP steps are held to that
file's O2 bounds (loss 2e-4 relative, gradients' effect through m
within 0.05 and v within 0.1 in relative norm, master within 2 lr a
step). Replicas on the port side are equal bit for bit."""

import datetime
import os
import sys
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from apex_tpu_torch.contrib.groupbn import BatchNorm2d_NHWC
from apex_tpu_torch.examples.bert.train import BertTrainStep
from apex_tpu_torch.examples.simple.distributed import (
    distributed_data_parallel as port_example,
)
from apex_tpu_torch.models.bert import bert_tiny as port_bert_tiny
from apex_tpu_torch.models.resnet import (
    apply_resnet, cross_entropy_loss as port_xent,
)
from apex_tpu_torch.parallel import (
    DistributedDataParallel, SyncBatchNorm, convert_syncbn_model,
)
from apex_tpu_torch.transformer import parallel_state as ps
from apex_tpu_torch.utils.tree import tree_flatten, tree_map, tree_unflatten

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
U = 2.0 ** -24
C = 5                       # SyncBN / groupbn channels
LR_RESNET = 0.1
BERT_BATCH, BERT_SEQ, BERT_LR = 4, 16, 1e-4
LAYOUTS = [(2, 1, 1, 2), (1, 2, 1, 2)]   # (dp, pp, cp, tp)
# the DDP example at W = 2: two O0 steps on a global batch of 16 (its
# weights' 8.4M threefry normals take most of a rank's time)
EXAMPLE_ARGS = ["--dp", "2", "--steps", "2", "-b", "16", "--opt-level",
                "O0"]
SYNCBN_CASES = {  # name -> (SyncBatchNorm kwargs, train)
    "nhwc": ({}, True),
    "nchw": ({"channel_last": False}, True),
    "no_affine": ({"affine": False}, True),
    "no_running_eval": ({"track_running_stats": False}, False),
}
GROUPBN_CASES = [(g, z, relu) for g in (1, 2, 0) for z, relu in
                 ((False, False), (True, True), (True, False))]


# ---------------------------------------------------------------------------
# inputs, from numpy seeds (both sides)
# ---------------------------------------------------------------------------

def grads_np(rank):
    rng = np.random.RandomState(100 + rank)
    return {"a": rng.randn(37, 5).astype(np.float32),
            "b": {"c": rng.randn(300).astype(np.float32),
                  "d": rng.randn(2, 3, 4).astype(np.float32)}}


def bcast_np(rank):
    rng = np.random.RandomState(200 + rank)
    return {"w": rng.randn(3, 7).astype(np.float32),
            "i": ((1 << 24) + 1 + 7 * rank + np.arange(5)).astype(np.int32),
            "m": rng.rand(6) > 0.5}


def bn_np(rank, dyadic=False, shape=(2, 4, 4, C), seed=300):
    """x, the cotangent, params and running state of a BatchNorm case;
    ``dyadic``: x in multiples of 1/8 in [-2, 2]."""
    rng = np.random.RandomState(seed + rank)
    if dyadic:
        x = rng.randint(-16, 17, size=shape).astype(np.float32) / 8
    else:
        x = (rng.randn(*shape) * 1.5 + 0.3).astype(np.float32)
    cot = rng.randn(*shape).astype(np.float32)
    prm = np.random.RandomState(seed - 1)
    params = {"scale": (1 + 0.1 * prm.randn(C)).astype(np.float32),
              "bias": (0.1 * prm.randn(C)).astype(np.float32)}
    state = {"mean": (0.1 * prm.randn(C)).astype(np.float32),
             "var": (1 + 0.1 * prm.rand(C)).astype(np.float32)}
    return x, cot, params, state


def overflow_np(rank):
    """A linear model's weights and a rank's batch; rank 0's batch holds
    an inf, so its gradients overflow."""
    rng = np.random.RandomState(13)
    w = rng.randn(4, 3).astype(np.float32)
    x = np.random.RandomState(14 + rank).randn(2, 4).astype(np.float32)
    if rank == 0:
        x[0, 0] = np.inf
    return w, x


def matmul_np():
    rng = np.random.RandomState(7)
    return (rng.randn(8, 6).astype(np.float32),
            rng.randn(6, 3).astype(np.float32))


def resnet_batch_np():
    rng = np.random.RandomState(11)
    return (rng.randn(8, 32, 32, 3).astype(np.float32),
            rng.randint(0, 10, size=8).astype(np.int32))


def bert_batch_np():
    rng = np.random.RandomState(12)
    return rng.randint(0, 512, size=(BERT_BATCH, BERT_SEQ)).astype(np.int32)


def _t(tree, dtype=None):
    return tree_map(lambda a: torch.from_numpy(np.array(a)) if dtype is None
                    else torch.from_numpy(np.array(a)).to(dtype), tree)


# ---------------------------------------------------------------------------
# the port side, run in each spawned rank
# ---------------------------------------------------------------------------

def _syncbn_port(name, rank, dyadic=False):
    kw, train = SYNCBN_CASES[name]
    x, cot, params, state = bn_np(rank, dyadic)
    if kw.get("channel_last") is False:
        x, cot = (np.ascontiguousarray(np.moveaxis(a, -1, 1))
                  for a in (x, cot))
    sbn = SyncBatchNorm(C, momentum=1.0 if dyadic else 0.1, **kw)
    p = _t(params) if sbn.affine else None
    st = _t(state) if sbn.track_running_stats else None
    xt = torch.from_numpy(x).requires_grad_(True)
    leaves = [xt] + ([p["scale"].requires_grad_(True),
                      p["bias"].requires_grad_(True)] if p else [])
    y, ns = sbn.apply(p, st, xt, train=train)
    grads = torch.autograd.grad((y * torch.from_numpy(cot)).sum(), leaves)
    return {"y": y.detach(), "state": ns, "grads": [g for g in grads]}


def _overflow_port(rank):
    """The DDP example's order of operations: found_inf from this rank's
    own gradients, then the all-reduce, then the step it gates."""
    from apex_tpu_torch import amp
    from apex_tpu_torch.optimizers import FusedSGD

    h = amp.initialize("O0", loss_scale="dynamic", verbosity=0)
    w, x = overflow_np(rank)
    p = {"w": torch.from_numpy(w)}
    opt = FusedSGD(lr=0.1)
    _, g, found, _ = h.value_and_grad(lambda p, x: (x @ p["w"]).sum())(
        h.cast_model(p), h.init_state("cpu"), torch.from_numpy(x))
    g = DistributedDataParallel().allreduce_grads(g)
    new, _ = opt.step(g, p, opt.init(p), found_inf=found)
    return {"found_inf": bool(found), "w": new["w"]}


def _groupbn_port(rank, bn_group, with_z, relu):
    x, cot, params, state = bn_np(rank, shape=(2, 3, 3, C), seed=400)
    z = torch.from_numpy(cot) if with_z else None
    bn = BatchNorm2d_NHWC(C, fuse_relu=relu, bn_group=bn_group)
    y, ns = bn.apply(_t(params), _t(state), torch.from_numpy(x), z,
                     train=True)
    return {"y": y, "state": ns}


def _resnet_port(rank, tmp):
    params, stats = torch.load(os.path.join(tmp, "resnet.pt"))
    x, y = (torch.from_numpy(a) for a in resnet_batch_np())
    ddp = DistributedDataParallel()
    x, y = ddp.shard_batch((x, y))
    params = ddp.broadcast_params(params)
    sync_apply = convert_syncbn_model(apply_resnet)
    flat, treedef = tree_flatten(params)
    flat = [t.detach().requires_grad_(True) for t in flat]
    logits, new_stats = sync_apply(tree_unflatten(treedef, flat), stats, x,
                                   10, train=True)
    loss = port_xent(logits, y)
    grads = ddp.allreduce_grads(tree_unflatten(
        treedef, list(torch.autograd.grad(loss, flat))))
    new = tree_map(lambda p, g: p - LR_RESNET * g, params, grads)
    loss = loss.detach().clone()
    dist.all_reduce(loss)
    return {"loss": loss / dist.get_world_size(), "params": new,
            "grads": grads, "stats": new_stats}


def _bert_port(rank, tmp):
    from apex_tpu_torch import amp
    from apex_tpu_torch.optimizers import FusedAdam

    master = torch.load(os.path.join(tmp, "bert.pt"))
    ddp = DistributedDataParallel()
    h = amp.initialize("O2", loss_scale="dynamic", verbosity=0)
    step = BertTrainStep(port_bert_tiny(), h,
                         FusedAdam(lr=BERT_LR, weight_decay=0.01), ddp=ddp)
    ids = torch.from_numpy(bert_batch_np()).long()
    ids, mask = ddp.shard_batch((ids, torch.ones_like(ids, dtype=torch.int32)))
    master = ddp.broadcast_params(master)
    state = (master, step.opt.init(master), h.init_state("cpu"))
    losses = []
    for _ in range(2):
        *state, loss = step(*state, ids, mask)
        losses.append(float(loss))
    return {"master": state[0], "m": state[1].m, "v": state[1].v,
            "scaler": [float(state[2].loss_scale), int(state[2].unskipped)],
            "losses": losses}


def job_w2(rank, world, tmp):
    out = {}
    ps.initialize_model_parallel(device="cpu")
    g = grads_np(rank)
    out["ar_bf16_fp32"] = DistributedDataParallel(
        allreduce_always_fp32=True).allreduce_grads(_t(g, torch.bfloat16))
    out["ar_bf16"] = DistributedDataParallel().allreduce_grads(
        _t(g, torch.bfloat16))
    out["ar_sum"] = DistributedDataParallel(
        gradient_average=False).allreduce_grads(_t(g))
    out["ar_sum_bucketed"] = DistributedDataParallel(
        gradient_average=False, message_size=64).allreduce_grads(_t(g))
    out["bcast"] = DistributedDataParallel().broadcast_params(
        _t(bcast_np(rank)))
    a, b = matmul_np()
    out["shard_map"] = ps.shard_map(
        lambda x, w: x @ w, in_specs=(ps.PartitionSpec(ps.DATA_AXIS),
                                      ps.PartitionSpec()),
        out_specs=ps.PartitionSpec(ps.DATA_AXIS))(
            torch.from_numpy(a), torch.from_numpy(b))
    for name in SYNCBN_CASES:
        out[f"bn_{name}"] = _syncbn_port(name, rank)
    out["bn_dyadic"] = _syncbn_port("nhwc", rank, dyadic=True)
    out["overflow"] = _overflow_port(rank)
    master, losses = port_example.train(port_example.parse_args(
        EXAMPLE_ARGS), "cpu")
    out["example"] = {"master": master, "losses": losses}
    out["bert"] = _bert_port(rank, tmp)
    return out


def job_w4(rank, world, tmp):
    out = {}
    for layout in LAYOUTS:
        dp, pp, cp, tp = layout
        ps.initialize_model_parallel(tp, pp, device="cpu")
        rec = {"ranks": [ps.get_data_parallel_rank(),
                         ps.get_pipeline_model_parallel_rank(),
                         ps.get_context_parallel_rank(),
                         ps.get_tensor_model_parallel_rank()],
               "sizes": [ps.get_data_parallel_world_size(),
                         ps.get_pipeline_model_parallel_world_size(),
                         ps.get_context_parallel_world_size(),
                         ps.get_tensor_model_parallel_world_size()],
               "members": [dist.get_process_group_ranks(gr) for gr in (
                   ps.get_data_parallel_group(),
                   ps.get_pipeline_model_parallel_group(),
                   ps.get_context_parallel_group(),
                   ps.get_tensor_model_parallel_group())],
               "first": ps.is_pipeline_first_stage(),
               "last": ps.is_pipeline_last_stage()}
        out[f"layout_{layout}"] = rec
        ps.destroy_model_parallel()
    ps.initialize_model_parallel(device="cpu")
    out["ar_sum"] = DistributedDataParallel(
        gradient_average=False).allreduce_grads(_t(grads_np(rank)))
    out["ar_avg"] = DistributedDataParallel().allreduce_grads(
        _t(grads_np(rank)))
    for name in SYNCBN_CASES:
        out[f"bn_{name}"] = _syncbn_port(name, rank)
    for case in GROUPBN_CASES:
        out[f"groupbn_{case}"] = _groupbn_port(rank, *case)
    out["resnet"] = _resnet_port(rank, tmp)
    return out


JOBS = {"w2": job_w2, "w4": job_w4}


def _rank_main(rank, world, tmp, job):
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{os.path.join(tmp, 'pg')}", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=120))
    try:
        out = JOBS[job](rank, world, tmp)
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        ps.destroy_model_parallel()
        dist.destroy_process_group()


def spawn(job, world, tmp, timeout=300):
    """Run ``job`` in ``world`` gloo ranks; returns each rank's results.
    Fails (and ends the ranks) past ``timeout`` seconds."""
    ctx = mp.spawn(_rank_main, args=(world, str(tmp), job), nprocs=world,
                   join=False)
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.terminate()
            pytest.fail(f"{job}: ranks did not finish in {timeout} s")
    return [torch.load(os.path.join(str(tmp), f"rank{r}.pt"))
            for r in range(world)]


# ---------------------------------------------------------------------------
# the JAX side
# ---------------------------------------------------------------------------

def _jax():
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from apex_tpu.transformer import parallel_state as jps
    return jax, jnp, P, jps


def _jax_mapped(world, f, in_specs, out_specs, *args):
    """``f`` jitted under the JAX package's shard_map on ``world``
    devices."""
    jax, _, _, jps = _jax()
    mesh = jps.initialize_model_parallel(devices=jax.devices()[:world])
    try:
        return jax.tree.map(np.asarray, jax.jit(jps.shard_map(
            f, mesh=mesh, in_specs=in_specs, out_specs=out_specs))(*args))
    finally:
        jps.destroy_model_parallel()


def _stacked(world, fn):
    """Per-rank numpy trees stacked on a new leading axis (sliced back
    to each rank by P("data"))."""
    trees = [fn(r) for r in range(world)]
    return tree_map_np(lambda *xs: np.stack(xs), *trees)


def tree_map_np(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: tree_map_np(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_np(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()
    return np.asarray(t, np.float32) if str(getattr(t, "dtype", "")) \
        == "bfloat16" else np.asarray(t)


def _by_path(tree, path=()):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_by_path(tree[k], path + (k,)))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_by_path(v, path + (i,)))
        return out
    return {path: tree}


def _pairs(want, got):
    a, b = _by_path(want), _by_path(got)
    assert a.keys() == b.keys()
    return [(k, _np(a[k]), _np(b[k])) for k in a]


def _close(want, got, rel=1e-5):
    """Per element within ``rel`` of the largest |want|."""
    for k, w, g in _pairs(want, got):
        assert g.shape == w.shape, k
        bound = rel * max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(g.astype(np.float64) - w).max())
        assert err <= bound, (k, err, bound)


def _bitwise(want, got):
    for k, w, g in _pairs(want, got):
        assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(g.view(np.uint8), w.view(np.uint8),
                                      err_msg=str(k))


@pytest.fixture(scope="module")
def w2(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("w2")
    jax, jnp, _, _ = _jax()
    from apex_tpu.models import bert as jax_bert
    from apex_tpu_torch.models._convert import params_from_jax

    torch.save(params_from_jax(jax.tree.map(np.asarray, jax_bert.init_bert(
        jax.random.PRNGKey(0), jax_bert.bert_tiny())), "cpu"),
        os.path.join(tmp, "bert.pt"))
    return spawn("w2", 2, tmp)


@pytest.fixture(scope="module")
def w4(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("w4")
    jax, _, _, _ = _jax()
    from apex_tpu.models import resnet as jax_resnet
    from apex_tpu_torch.models._convert import params_from_jax

    params, stats = jax_resnet.init_resnet(jax.random.PRNGKey(0), 10, 10)
    torch.save(tuple(params_from_jax(jax.tree.map(np.asarray, t), "cpu")
                     for t in (params, stats)),
               os.path.join(tmp, "resnet.pt"))
    return spawn("w4", 4, tmp)


# ---------------------------------------------------------------------------
# DistributedDataParallel
# ---------------------------------------------------------------------------

def _jax_allreduce(world, dtype, **kw):
    jax, jnp, P, _ = _jax()
    from apex_tpu.parallel import DistributedDataParallel as JDDP

    ddp = JDDP(**kw)
    g = jax.tree.map(lambda a: jnp.asarray(a).astype(dtype),
                     _stacked(world, grads_np))
    return _jax_mapped(world, lambda t: ddp.allreduce_grads(
        jax.tree.map(lambda a: a[0], t)), P("data"), P(), g)


@pytest.mark.parametrize("key,dtype,kw", [
    ("ar_bf16_fp32", "bfloat16", {"allreduce_always_fp32": True}),
    ("ar_bf16", "bfloat16", {}),
    ("ar_sum", "float32", {"gradient_average": False}),
    ("ar_sum_bucketed", "float32", {"gradient_average": False})],
    ids=["bf16_via_fp32", "bf16", "fp32_sum", "fp32_sum_bucketed"])
def test_allreduce_grads_w2_bitwise(w2, key, dtype, kw):
    """``allreduce_grads`` at W = 2 on every rank equals the JAX
    ``psum`` / ``psum(1)`` bit for bit, each leaf in its own dtype;
    buckets of 64 elements give the same bits as one bucket a dtype."""
    import jax.numpy as jnp

    want = _jax_allreduce(2, getattr(jnp, dtype), **kw)
    for rank in range(2):
        got = w2[rank][key]
        assert {str(t.dtype) for t in _by_path(got).values()} == {
            f"torch.{dtype}"}
        _bitwise(want, got)


@pytest.mark.parametrize("key,avg", [("ar_sum", False), ("ar_avg", True)])
def test_allreduce_grads_w4_within_ulps(w4, key, avg):
    """At W = 4 the ring sums in another order: within 4 ulps of the sum
    of |terms| (8 with the average's division), every rank the same
    bits."""
    import jax.numpy as jnp

    want = _jax_allreduce(4, jnp.float32, gradient_average=avg)
    terms = [grads_np(r) for r in range(4)]
    abs_sum = tree_map_np(lambda *xs: sum(np.abs(x) for x in xs), *terms)
    for rank in range(4):
        _bitwise(_by_path(w4[0][key]), _by_path(w4[rank][key]))
        for (k, w, g), (_, s, _) in zip(_pairs(want, w4[rank][key]),
                                        _pairs(abs_sum, w4[rank][key])):
            lim = (8 if avg else 4) * U * s / (4 if avg else 1)
            assert (np.abs(g - w) <= lim).all(), k


def test_broadcast_params_gives_rank0s_bits(w2):
    """fp32, int32 above 2^24 and bool leaves: every rank holds rank 0's
    values exactly, as the JAX masked-psum broadcast gives them."""
    jax, jnp, P, _ = _jax()
    from apex_tpu.parallel import DistributedDataParallel as JDDP

    want = _jax_mapped(2, lambda t: JDDP().broadcast_params(
        jax.tree.map(lambda a: a[0], t)), P("data"), P(),
        _stacked(2, bcast_np))
    for rank in range(2):
        _bitwise(want, w2[rank]["bcast"])
        _bitwise(bcast_np(0), w2[rank]["bcast"])
    assert w2[1]["bcast"]["i"][0] == (1 << 24) + 1


# ---------------------------------------------------------------------------
# parallel_state
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", LAYOUTS, ids=str)
def test_parallel_state_matches_the_jax_mesh(w4, layout):
    """Ranks, world sizes and group members for (dp, pp, cp, tp): rank r
    sits where the JAX mesh puts device r, and each axis's group is the
    line of ranks along it."""
    jax, _, _, jps = _jax()
    dp, pp, cp, tp = layout
    devs = jax.devices()[:4]
    mesh = jps.initialize_model_parallel(tp, pp, devices=devs)
    try:
        sizes = [jps.get_data_parallel_world_size(),
                 jps.get_pipeline_model_parallel_world_size(),
                 jps.get_context_parallel_world_size(),
                 jps.get_tensor_model_parallel_world_size()]
        ids = np.vectorize(lambda d: devs.index(d))(mesh.devices)
    finally:
        jps.destroy_model_parallel()
    assert sizes == [dp, pp, cp, tp]
    for rank in range(4):
        rec = w4[rank][f"layout_{layout}"]
        coords = [int(c) for c in np.argwhere(ids == rank)[0]]
        assert rec["ranks"] == coords and rec["sizes"] == sizes
        for ax, members in enumerate(rec["members"]):
            idx = list(coords)
            idx[ax] = slice(None)
            assert members == sorted(ids[tuple(idx)].tolist()), ax
        assert rec["first"] == (coords[1] == 0)
        assert rec["last"] == (coords[1] == pp - 1)


def test_shard_map_slices_and_gathers(w2):
    """``P("data")`` inputs are sliced by data rank, ``P()`` passed
    whole, ``P("data")`` outputs gathered in data order: the JAX
    shard_map's result, on every rank."""
    _, _, P, _ = _jax()
    a, b = matmul_np()
    want = _jax_mapped(2, lambda x, w: x @ w, (P("data"), P()), P("data"),
                       a, b)
    for rank in range(2):
        np.testing.assert_allclose(w2[rank]["shard_map"].numpy(), want,
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("axis", [ps.PIPE_AXIS, ps.CONTEXT_AXIS])
def test_shard_map_refuses_other_axes(axis):
    """The pipe and context axes are taken like data and model (the name
    is kept from the slices when they raised, naming A6.2; their splits
    over several ranks are ``tests/test_torch_pipeline_parallel.py``'s
    and ``tests/test_torch_context_parallel.py``'s): on a world of one a
    spec over either passes its value whole, as an input or an output;
    an axis the mesh does not have is refused at the spec."""
    P = ps.PartitionSpec
    ps.initialize_model_parallel(device="cpu")
    try:
        x = torch.arange(4.0).reshape(2, 2)
        got = ps.shard_map(lambda x: {"a": x * 2}, in_specs=P(None, axis),
                           out_specs={"a": P(axis)})(x)
        assert torch.equal(got["a"], x * 2)
        with pytest.raises(ps.ParallelStateError, match="unknown mesh axis"):
            ps.shard_map(lambda x: x, in_specs=P(None, "pipes"),
                         out_specs=P())(x)
    finally:
        ps.destroy_model_parallel()
        torch.distributed.destroy_process_group()


def test_initialize_model_parallel_world_of_one_on_cpu():
    """``device="cpu"`` with no process group and no launcher's
    environment brings up a gloo world of one; the groups are real
    process groups and the ranks plain ints."""
    assert not dist.is_initialized()
    try:
        mesh = ps.initialize_model_parallel(device="cpu")
        assert dist.get_backend() == "gloo"
        assert mesh.shape == {"data": 1, "pipe": 1, "context": 1,
                              "model": 1}
        g = ps.get_data_parallel_group()
        assert isinstance(g, dist.ProcessGroup)
        assert ps.get_data_parallel_rank() == 0
        assert ps.get_tensor_model_parallel_world_size() == 1
        t = torch.ones(3)
        dist.all_reduce(t, group=g)
        assert t.tolist() == [1.0, 1.0, 1.0]
        with pytest.raises(ps.ParallelStateError, match="divisible"):
            ps.initialize_model_parallel(2, device="cpu")
    finally:
        ps.destroy_model_parallel()
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# SyncBatchNorm, layers.batchnorm(axis_name=), groupbn
# ---------------------------------------------------------------------------

def _jax_syncbn(world, name, dyadic=False):
    jax, jnp, P, _ = _jax()
    from apex_tpu.parallel import SyncBatchNorm as JSBN

    kw, train = SYNCBN_CASES[name]
    sbn = JSBN(C, momentum=1.0 if dyadic else 0.1, **kw)
    first = kw.get("channel_last") is False

    def case(r):
        x, cot, _, _ = bn_np(r, dyadic)
        if first:
            x, cot = (np.moveaxis(a, -1, 1) for a in (x, cot))
        return x, cot

    xs, cots = _stacked(world, case)
    _, _, params, state = bn_np(0, dyadic)
    params = params if sbn.affine else None
    state = state if sbn.track_running_stats else None

    def f(x, cot, params, state):
        x, cot = x[0], cot[0]

        def loss(x, p):
            y, ns = sbn.apply(p, state, x, train=train)
            return jnp.sum(y * cot), (y, ns)

        (_, (y, ns)), g = jax.value_and_grad(loss, argnums=(0, 1),
                                             has_aux=True)(x, params)
        return y[None], ns, jax.tree.map(lambda a: a[None], g)

    y, ns, (gx, gp) = _jax_mapped(world, f, (P("data"), P("data"), P(),
                                             P()),
                                  (P("data"), P(), P("data")), xs, cots,
                                  params, state)
    return y, ns, gx, gp


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", sorted(SYNCBN_CASES))
def test_sync_batchnorm_matches_jax(w2, w4, world, name):
    """Outputs, running statistics and each rank's input (and affine)
    gradients against ``jax.grad`` through shard_map: channel-last,
    channel-first, no affine, and no running stats (batch statistics,
    synced, in eval); every rank's statistics the same bits."""
    res = {2: w2, 4: w4}[world]
    y, ns, gx, gp = _jax_syncbn(world, name)
    for rank in range(world):
        got = res[rank][f"bn_{name}"]
        _close(y[rank], got["y"])
        if ns is None:
            assert got["state"] is None
        else:
            _close(ns, got["state"])
            _bitwise(_by_path(res[0][f"bn_{name}"]["state"]),
                     _by_path(got["state"]))
        _close(gx[rank], got["grads"][0])
        if gp is not None:
            _close(gp["scale"][rank], got["grads"][1])
            _close(gp["bias"][rank], got["grads"][2])
        else:
            assert len(got["grads"]) == 1


def test_sync_batchnorm_statistics_bitwise_w2(w2):
    """On inputs whose local sums are exact (multiples of 1/8, 32 a
    channel a rank), the synced batch mean and unbiased variance equal
    JAX's ``pmean`` bit for bit at W = 2, on both ranks (read as the
    running statistics at momentum 1, which keep none of the old)."""
    _, ns, _, _ = _jax_syncbn(2, "nhwc", dyadic=True)
    for rank in range(2):
        _bitwise(ns, w2[rank]["bn_dyadic"]["state"])


@pytest.mark.parametrize("case", GROUPBN_CASES,
                         ids=lambda c: f"bn_group{c[0]}_z{int(c[1])}_"
                         f"relu{int(c[2])}")
def test_groupbn_matches_jax(w4, case):
    """``BatchNorm2d_NHWC`` at W = 4 with ``bn_group`` 1 (rank-local), 2
    (two groups of consecutive ranks) and 0 (the whole axis), with and
    without the residual ``z`` and the ReLU: outputs and running
    statistics per rank against the JAX module through shard_map."""
    jax, jnp, P, _ = _jax()
    from apex_tpu.contrib.groupbn import BatchNorm2d_NHWC as JBN

    bn_group, with_z, relu = case
    bn = JBN(C, fuse_relu=relu, bn_group=bn_group)

    def per_rank(r):
        x, cot, _, _ = bn_np(r, shape=(2, 3, 3, C), seed=400)
        return x, cot

    xs, zs = _stacked(4, per_rank)
    _, _, params, state = bn_np(0, shape=(2, 3, 3, C), seed=400)

    def f(x, z):
        y, ns = bn.apply(params, state, x[0], z[0] if with_z else None,
                         train=True)
        return y[None], jax.tree.map(lambda a: a[None], ns)

    y, ns = _jax_mapped(4, f, (P("data"), P("data")),
                        (P("data"), P("data")), xs, zs)
    for rank in range(4):
        got = w4[rank][f"groupbn_{case}"]
        _close(y[rank], got["y"])
        _close(jax.tree.map(lambda a: a[rank], ns), got["state"])
    if bn_group == 2:   # the two groups see different statistics
        assert not torch.equal(w4[0][f"groupbn_{case}"]["state"]["mean"],
                               w4[2][f"groupbn_{case}"]["state"]["mean"])
        assert torch.equal(w4[0][f"groupbn_{case}"]["state"]["mean"],
                           w4[1][f"groupbn_{case}"]["state"]["mean"])


def test_resnet_syncbn_step_matches_jax(w4):
    """``convert_syncbn_model(apply_resnet)`` on ResNet-10 at 32 px, a
    global batch of 8 over W = 4: one SGD step (loss, all-reduced
    gradients, new params and synced BatchNorm statistics) against the
    JAX step through shard_map; the ranks' new params the same bits."""
    jax, jnp, P, _ = _jax()
    from apex_tpu.models import resnet as jr
    from apex_tpu.parallel import DistributedDataParallel as JDDP
    from apex_tpu.parallel import convert_syncbn_model as jconvert

    params, stats = jr.init_resnet(jax.random.PRNGKey(0), 10, 10)
    x, y = resnet_batch_np()
    ddp = JDDP()
    sync_apply = jconvert(jr.apply_resnet)

    def step(params, stats, x, y):
        def loss_fn(p):
            logits, ns = sync_apply(p, stats, x, 10, train=True)
            return jr.cross_entropy_loss(logits, y), ns

        (loss, ns), g = jax.value_and_grad(loss_fn, has_aux=True)(params)
        g = ddp.allreduce_grads(g)
        new = jax.tree.map(lambda p, g: p - LR_RESNET * g, params, g)
        return new, g, ns, jax.lax.pmean(loss, "data")

    new, g, ns, loss = _jax_mapped(
        4, step, (P(), P(), P("data"), P("data")), (P(), P(), P(), P()),
        params, stats, x, y)
    for rank in range(4):
        got = w4[rank]["resnet"]
        assert abs(float(got["loss"]) - float(loss)) <= 1e-5 * abs(
            float(loss))
        for k, w, gg in _pairs(g, got["grads"]):
            n = float(np.linalg.norm(w))
            assert float(np.linalg.norm(gg - w)) <= 1e-4 * max(n, 1e-30), k
        for (k, w, p), (_, gw, _) in zip(_pairs(new, got["params"]),
                                         _pairs(g, got["grads"])):
            lim = LR_RESNET * 1e-4 * float(np.linalg.norm(gw)) + 4 * U * (
                np.abs(w) + LR_RESNET * np.abs(gw))
            assert (np.abs(p - w) <= lim).all(), k
        _close(ns, got["stats"])
        _bitwise(_by_path(w4[0]["resnet"]["params"]),
                 _by_path(got["params"]))


# ---------------------------------------------------------------------------
# the DDP example and the DDP BERT step
# ---------------------------------------------------------------------------

def _jax_example():
    import contextlib
    import io
    import runpy

    jax, _, _, jps = _jax()
    buf = io.StringIO()
    argv = sys.argv
    sys.argv = ["distributed_data_parallel.py"] + EXAMPLE_ARGS
    try:
        with contextlib.redirect_stdout(buf):
            runpy.run_path(os.path.join(
                REPO, "examples/simple/distributed/distributed_data_parallel.py"),
                run_name="__main__")
    finally:
        sys.argv = argv
        jps.destroy_model_parallel()
    return {int(line.split()[1]): float(line.split()[-1])
            for line in buf.getvalue().splitlines()
            if line.startswith("step")}


def test_ddp_example_matches_the_jax_script(w2):
    """The port of ``examples/simple/distributed/distributed_data_parallel.py``
    at W = 2: the printed losses against the JAX script's at ``--dp 2``
    (two O0 steps, a global batch of 16) within 1e-5, and the two ranks'
    master params bit for bit."""
    want = _jax_example()
    got = w2[0]["example"]
    assert sorted(got["losses"]) == sorted(want) == [0, 1]
    for i, w in want.items():
        assert abs(got["losses"][i] - w) <= 1e-5 * max(abs(w), 1.0), (i, w)
    _bitwise(_by_path(got["master"]), _by_path(w2[1]["example"]["master"]))
    assert w2[1]["example"]["losses"] == got["losses"]


def test_one_rank_overflow_keeps_the_references_order(w2):
    """A known behaviour of the reference, kept: each rank takes
    ``found_inf`` from its own gradients before the all-reduce, so when
    only rank 0 overflows, rank 0 skips its step while rank 1 steps on
    all-reduced gradients that carry rank 0's inf: the replicas part, on
    the port (two processes) as on the JAX shard_map step (each device's
    params read back)."""
    jax, jnp, P, _ = _jax()
    from apex_tpu import amp as jamp
    from apex_tpu.optimizers import FusedSGD as JSGD
    from apex_tpu.parallel import DistributedDataParallel as JDDP

    h = jamp.initialize("O0", loss_scale="dynamic", verbosity=0)
    opt, ddp = JSGD(lr=0.1), JDDP()
    w, _ = overflow_np(0)
    xs = np.stack([overflow_np(r)[1] for r in range(2)])

    def f(w, x):
        p = {"w": w}
        _, g, found, _ = h.value_and_grad(lambda p: jnp.sum(x[0] @ p["w"]))(
            h.cast_model(p), h.init_state())
        new, _ = opt.step(ddp.allreduce_grads(g), p, opt.init(p),
                          found_inf=found)
        return new["w"][None], found[None]

    new_w, found = _jax_mapped(2, f, (P(), P("data")), (P("data"),
                                                         P("data")), w, xs)
    assert [bool(v) for v in found] == [
        w2[r]["overflow"]["found_inf"] for r in range(2)] == [True, False]
    for r in range(2):
        np.testing.assert_array_equal(w2[r]["overflow"]["w"].numpy(),
                                      new_w[r])
    np.testing.assert_array_equal(new_w[0], w)
    # rank 1 stepped: the row the inf reached is gone non-finite
    assert not np.isfinite(new_w[1][0]).any()
    assert np.isfinite(new_w[1][1:]).all() and (new_w[1][1:] != w[1:]).all()


def test_ddp_bert_tiny_two_steps_match_jax(w2):
    """Two O2 steps of ``bert_tiny`` on a global batch of 4 over W = 2
    (``BertTrainStep(..., ddp=)``) against the JAX shard_map step with
    ``allreduce_grads`` between the gradients and ``FusedAdam``: losses,
    master, m, v and the scaler within ``tests/test_torch_bert_train.py``'s
    O2 bounds; the ranks' masters the same bits."""
    jax, jnp, P, _ = _jax()
    from apex_tpu import amp as jamp
    from apex_tpu.models import bert as jb
    from apex_tpu.optimizers import FusedAdam as JAdam
    from apex_tpu.parallel import DistributedDataParallel as JDDP

    cfg = jb.bert_tiny()
    h = jamp.initialize("O2", loss_scale="dynamic", verbosity=0)
    opt = JAdam(lr=BERT_LR, weight_decay=0.01)
    ddp = JDDP()
    master = jb.init_bert(jax.random.PRNGKey(0), cfg)
    ids = bert_batch_np()
    mask = np.ones_like(ids)

    def step(master, opt_state, sc, ids, mask):
        def loss_fn(p):
            return jb.mlm_loss(jb.apply_bert(p, cfg, ids, mask)["mlm_logits"],
                               ids, mask)

        p = h.cast_model(master)
        loss, g, found_inf, sc = h.value_and_grad(loss_fn)(p, sc)
        g = ddp.allreduce_grads(g)
        master, opt_state = opt.step(g, master, opt_state,
                                     found_inf=found_inf)
        return master, opt_state, sc, jax.lax.pmean(loss, "data")

    _, _, _, jps = _jax()
    mesh = jps.initialize_model_parallel(devices=jax.devices()[:2])
    try:
        f = jax.jit(jps.shard_map(
            step, mesh=mesh, in_specs=(P(), P(), P(), P("data"), P("data")),
            out_specs=(P(), P(), P(), P())))
        state = (master, opt.init(master), h.init_state())
        losses = []
        for _ in range(2):
            *state, loss = f(*state, ids, mask)
            losses.append(float(loss))
        state = jax.tree.map(np.asarray, state)
    finally:
        jps.destroy_model_parallel()
    got = w2[0]["bert"]
    for w, g in zip(losses, got["losses"]):
        assert abs(g - w) <= 2e-4 * abs(w), (g, w)
    assert got["scaler"] == [float(state[2].loss_scale),
                             int(state[2].unskipped)]
    for k, w, g in _pairs(state[0], got["master"]):
        assert float(np.abs(g - w).max()) <= 2 * 2 * BERT_LR, k
    for name, tree, tol in (("m", state[1].m, 0.05), ("v", state[1].v, 0.1)):
        for k, w, g in _pairs(tree, got[name]):
            n = float(np.linalg.norm(w))
            assert float(np.linalg.norm(g - w)) <= tol * max(n, 1e-30), \
                (name, k)
    _bitwise(_by_path(got["master"]), _by_path(w2[1]["bert"]["master"]))

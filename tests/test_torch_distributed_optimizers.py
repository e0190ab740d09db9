"""Port parity of ``contrib/optimizers`` (ZeRO: ``DistributedFusedAdam``
and ``DistributedFusedLAMB``) and of ``utils/checkpoint``'s sharded pair
against the JAX package on the CPU.

The reference's ``test_distributed_optimizers.py`` cases at dp 2 and dp 4
gloo ranks (``tests/_torch_ranks.py``), each rank stepping inside the
port's ``parallel_state.shard_map`` on its own gradients and its rows of
the state: two steps against the JAX optimizer on a dp-device mesh and
against the port's unsharded ``FusedAdam`` / ``FusedLAMB`` on the
rank-mean gradients (2e-5 relative, 1e-6 absolute, the reference's);
an overflow on one rank skips the step on every rank; the state at rest
is this rank's rows: two chained steps take and return the rank's
``(R/dp, 128)`` master, m and v (``in_specs`` and ``out_specs`` ``P()``
on the state), ``state_bytes_per_device`` three times their bytes, and
the params the same bits as the route that gathers the state back
(``out_specs`` the state's ``partition_spec()``); ``grad_scale``
unscales; LAMB's trust ratio spans the split; a bf16 first moment (the
state's bytes 10/12 of fp32's, the params within 1e-3 / 1e-4 of the
fp32 run).

The reference's two sharded-checkpoint cases: after two steps on the
rows at rest each rank writes its own file (``save_sharded_checkpoint(
path, state, specs=opt.partition_spec())``) holding exactly its one
block of master, m and v (``R/dp`` rows) and a dense step; the union of
the ranks' blocks has the slices of the JAX package's
``save_sharded_checkpoint`` records of the same two steps on a
dp-device mesh, their values within the tolerance above, and equals bit
for bit the JAX records of the port's own state placed on that mesh;
the third step resumed from a fresh init equals the uninterrupted one
bit for bit; a bf16 m stays bf16; a file of another data-parallel size
(or another rank's) raises the reference's "resume topology mismatch".
The params and the per-rank gradients are the reference's draws,
carried across as numpy. This module imports no JAX at its top."""

import functools
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from _torch_ranks import spawn
from apex_tpu_torch.contrib.optimizers import (
    DistributedFusedAdam, DistributedFusedLAMB,
)
from apex_tpu_torch.optimizers import FusedAdam, FusedLAMB
from apex_tpu_torch.transformer import parallel_state as ps
from apex_tpu_torch.utils.checkpoint import (
    load_sharded_checkpoint, save_sharded_checkpoint,
)
from apex_tpu_torch.utils.tree import tree_map

P = ps.PartitionSpec
CASES = {"adamw": ("adam", dict(weight_decay=0.01)),
         "adam_l2": ("adam", dict(adam_w_mode=False, weight_decay=0.1)),
         "lamb": ("lamb", dict(weight_decay=0.01))}
PORT = {"adam": (DistributedFusedAdam, FusedAdam),
        "lamb": (DistributedFusedLAMB, FusedLAMB)}
LR = 1e-2
S = 2.0 ** 12


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the JAX side (memoized; imported lazily)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _rig():
    import importlib.util

    path = os.path.join(os.path.dirname(__file__), "L0", "run_optimizers",
                        "test_distributed_optimizers.py")
    spec = importlib.util.spec_from_file_location("_jax_zero_rig", path)
    rig = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(rig)
    return rig


def _np_tree(tree):
    import jax
    return jax.tree.map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _params(seed):
    import jax
    return _np_tree(_rig().make_params(jax.random.PRNGKey(seed)))


@functools.lru_cache(maxsize=None)
def _grads(seed, pseed, dp):
    import jax
    return _np_tree(_rig().per_rank_grads(jax.random.PRNGKey(seed),
                                          _params(pseed), n=dp))


@functools.lru_cache(maxsize=None)
def _jax_steps(name, dp, seeds, pseed=0, lr=LR):
    """The JAX optimizer's params after one step a gradient seed, on a
    dp-device data mesh."""
    import jax
    from jax.sharding import PartitionSpec as JP

    from apex_tpu.contrib import optimizers as jopt
    from apex_tpu.transformer import parallel_state as jps

    kind, kw = CASES[name]
    cls = {"adam": jopt.DistributedFusedAdam,
           "lamb": jopt.DistributedFusedLAMB}[kind]
    jps.initialize_model_parallel(devices=jax.devices()[:dp])
    try:
        opt = cls(lr=lr, dp_size=dp, **kw)
        params = _params(pseed)
        st = opt.init(params)
        sspec = opt.partition_spec()
        pspec = jax.tree.map(lambda _: JP(), params)
        step = jax.jit(jps.shard_map(
            lambda g, p, s: opt.step(g, p, s),
            in_specs=(jax.tree.map(lambda _: JP(jps.DATA_AXIS), params),
                      pspec, sspec), out_specs=(pspec, sspec)))
        out = []
        for seed in seeds:
            params, st = step(_grads(seed, pseed, dp), params, st)
            out.append(_np_tree(params))
        return out
    finally:
        jps.destroy_model_parallel()


def _t(tree):
    return {k: _t(v) if isinstance(v, dict)
            else torch.from_numpy(np.array(v)) for k, v in tree.items()}


# ---------------------------------------------------------------------------
# the port side, in each rank
# ---------------------------------------------------------------------------

def _zero(opt, params, st, grads, **kw):
    """One ZeRO step inside shard_map: this rank's gradients (its slice
    of the stacked (dp, ...) leaves) and rows; the state gathered
    back."""
    sspec = opt.partition_spec()

    def body(g, p, s, found_inf=None):
        g = tree_map(lambda a: a[0], g)
        if found_inf is not None:
            kw["found_inf"] = found_inf[0]
        return opt.step(g, p, s, **kw)

    gspec = tree_map(lambda _: P(ps.DATA_AXIS), grads)
    if "found_inf" in kw:
        flags = kw.pop("found_inf")
        return ps.shard_map(body, in_specs=(gspec, P(), sspec,
                                            P(ps.DATA_AXIS)),
                            out_specs=(P(), sspec))(grads, params, st, flags)
    return ps.shard_map(body, in_specs=(gspec, P(), sspec),
                        out_specs=(P(), sspec))(grads, params, st)


def _at_rest(opt, st):
    """This rank's rows of a whole state (what a rank keeps between
    steps)."""
    return ps._map_specs(ps.shard_leaf, opt.partition_spec(), st)


def _zero_rows(opt, params, st, grads):
    """One ZeRO step on the state held at rest: this rank's rows in and
    out, nothing gathered but the params."""
    gspec = tree_map(lambda _: P(ps.DATA_AXIS), grads)
    return ps.shard_map(
        lambda g, p, s: opt.step(tree_map(lambda a: a[0], g), p, s),
        in_specs=(gspec, P(), P()), out_specs=(P(), P()))(grads, params, st)


def _sharded_ckpt(rank, world, tmp, d, m_dtype, tag):
    """The reference's sharded-checkpoint case on this rank: two steps on
    the rows at rest, one file a rank, the third step uninterrupted and
    resumed from a fresh init."""
    opt = DistributedFusedAdam(lr=LR, weight_decay=0.01, dp_size=world,
                               m_dtype=m_dtype)
    specs = opt.partition_spec()
    p = d["params"][0]
    st = _at_rest(opt, opt.init(p))
    for seed in (0, 1):
        p, st = _zero_rows(opt, p, st, d["grads"][seed])
    path = os.path.join(tmp, f"zero_{tag}_{rank}.ckpt")
    save_sharded_checkpoint(path, st, specs=specs)
    recs = torch.load(path, weights_only=False)
    want, _ = _zero_rows(opt, p, st, d["grads"][99])
    resumed = load_sharded_checkpoint(path, _at_rest(opt, opt.init(p)),
                                      specs=specs)
    got, _ = _zero_rows(opt, p, resumed, d["grads"][99])
    return dict(recs=recs, want=want, got=got, m_dtype=resumed.m.dtype,
                m_equal=torch.equal(resumed.m, st.m), params=p)


def _mismatch(rank, world, tmp):
    """The reference's topology refusal, raised: at dp 2 the other
    rank's file (its slices are not this rank's), at dp 4 this rank's
    file of a dp-2 state (tp 2 x dp 2 over the same ranks)."""
    tiny = {"w": torch.zeros(64, 64)}
    if world == 4:
        ps.destroy_model_parallel()
        ps.initialize_model_parallel(2, device="cpu")
        opt2 = DistributedFusedAdam(lr=LR, dp_size=2)
        path = os.path.join(tmp, f"zero_dp2_{rank}.ckpt")
        save_sharded_checkpoint(path, _at_rest(opt2, opt2.init(tiny)),
                                specs=opt2.partition_spec())
        ps.destroy_model_parallel()
        ps.initialize_model_parallel(device="cpu")
    opt = DistributedFusedAdam(lr=LR, dp_size=world)
    tmpl = _at_rest(opt, opt.init(tiny))
    if world != 4:
        save_sharded_checkpoint(os.path.join(tmp, f"zero_tiny_{rank}.ckpt"),
                                tmpl, specs=opt.partition_spec())
        dist.barrier()
        path = os.path.join(tmp, f"zero_tiny_{(rank + 1) % world}.ckpt")
    try:
        load_sharded_checkpoint(path, tmpl, specs=opt.partition_spec())
    except ValueError as e:
        return str(e)
    return None


def job(rank, world, tmp):
    d = torch.load(os.path.join(tmp, "inputs.pt"))
    ps.initialize_model_parallel(device="cpu")
    out = {}
    for name, (kind, kw) in CASES.items():
        opt = PORT[kind][0](lr=LR, dp_size=world, **kw)
        p, st = d["params"][0], opt.init(d["params"][0])
        out[name] = []
        for seed in (10, 11):
            p, st = _zero(opt, p, st, d["grads"][seed])
            out[name].append(p)
    # an overflow on rank 1 only skips the step everywhere
    opt = DistributedFusedAdam(lr=LR, dp_size=world)
    st = opt.init(d["params"][0])
    flags = torch.arange(world) == 1
    p, st2 = _zero(opt, d["params"][0], st, d["grads"][1], found_inf=flags)
    out["overflow"] = (p, st2._asdict(), st._asdict())
    # the state at rest: this rank's rows, chained through two steps,
    # against the gathered route's params (CASES["adamw"])
    opt = DistributedFusedAdam(lr=LR, dp_size=world, weight_decay=0.01)
    p, st = d["params"][0], opt.init(d["params"][0])
    full = tuple(st.m.shape)
    st = _at_rest(opt, st)
    held = []
    for seed in (10, 11):
        p, st = _zero_rows(opt, p, st, d["grads"][seed])
        held.append(tuple(st.m.shape))
    out["rest"] = (held, st.m.numel() * 4, opt.state_bytes_per_device(p),
                   full, p)
    # the sharded checkpoint: fp32 and bf16 m
    out["ckpt"] = {tag: _sharded_ckpt(rank, world, tmp, d, mdt, tag)
                   for tag, mdt in (("fp32", torch.float32),
                                    ("bf16m", torch.bfloat16))}
    dist.barrier()
    out["mismatch"] = _mismatch(rank, world, tmp)
    # grad_scale multiplies: 1/S on S-scaled gradients
    plain = DistributedFusedAdam(lr=LR, dp_size=world)
    scaled = DistributedFusedAdam(lr=LR, dp_size=world)
    out["scale"] = (
        _zero(plain, d["params"][0], plain.init(d["params"][0]),
              d["grads"][2])[0],
        _zero(scaled, d["params"][0], scaled.init(d["params"][0]),
              tree_map(lambda a: a * S, d["grads"][2]),
              grad_scale=1.0 / S)[0])
    # LAMB's trust ratio over the split (a larger lr, other params)
    lamb = DistributedFusedLAMB(lr=5e-2, weight_decay=0.01, dp_size=world)
    out["trust"] = _zero(lamb, d["params"][3], lamb.init(d["params"][3]),
                         d["grads"][4])[0]
    # a bf16 first moment against fp32 state
    for cls in (DistributedFusedAdam, DistributedFusedLAMB):
        o32 = cls(lr=LR, weight_decay=0.01, dp_size=world)
        obf = cls(lr=LR, weight_decay=0.01, dp_size=world,
                  m_dtype=torch.bfloat16)
        p32, s32 = d["params"][5], o32.init(d["params"][5])
        pbf, sbf = d["params"][5], obf.init(d["params"][5])
        for seed in (40, 41):
            p32, s32 = _zero(o32, p32, s32, d["grads"][seed])
            pbf, sbf = _zero(obf, pbf, sbf, d["grads"][seed])
        out[("bf16", cls.__name__)] = (
            p32, pbf, sbf.m.dtype, obf.state_bytes_per_device(pbf),
            o32.state_bytes_per_device(p32))
    return out


def _inputs_file(tmp, world):
    torch.save({"params": {s: _t(_params(s)) for s in (0, 3, 5)},
                "grads": {s: _t(_grads(s, {0: 0, 1: 0, 2: 0, 4: 3, 10: 0,
                                           11: 0, 40: 5, 41: 5, 99: 0}[s],
                                       world))
                          for s in (0, 1, 2, 4, 10, 11, 40, 41, 99)}},
               os.path.join(tmp, "inputs.pt"))


@pytest.fixture(scope="module")
def w2(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("zero2")
    _inputs_file(tmp, 2)
    return spawn(job, 2, tmp)


@pytest.fixture(scope="module")
def w4(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("zero4")
    _inputs_file(tmp, 4)
    return spawn(job, 4, tmp)


# ---------------------------------------------------------------------------
# comparisons
# ---------------------------------------------------------------------------

def _close(got, want, rtol=2e-5, atol=1e-6):
    for k in want:
        if isinstance(want[k], dict):
            _close(got[k], want[k], rtol, atol)
        else:
            w = want[k].numpy() if isinstance(want[k], torch.Tensor) \
                else want[k]
            np.testing.assert_allclose(got[k].numpy(), w, rtol=rtol,
                                       atol=atol, err_msg=k)


def _unsharded(name, dp, seeds, pseed=0, lr=LR):
    kind, kw = CASES[name]
    ref = PORT[kind][1](lr=lr, **kw)
    p = _t(_params(pseed))
    st = ref.init(p)
    out = []
    for seed in seeds:
        g = tree_map(lambda a: a.mean(0), _t(_grads(seed, pseed, dp)))
        p, st = ref.step(g, p, st)
        out.append(p)
    return out


@pytest.mark.parametrize("dp", [2, 4])
@pytest.mark.parametrize("name", sorted(CASES))
def test_matches_unsharded_reference(name, dp, request):
    """Two ZeRO steps equal the JAX optimizer's and the port's replicated
    optimizer's on the rank-mean gradient (step 2 runs the nonzero-state
    recurrence, where a split error would show)."""
    res = request.getfixturevalue(f"w{dp}")
    jax_ps = _jax_steps(name, dp, (10, 11))
    port_ps = _unsharded(name, dp, (10, 11))
    for r in res:
        for got, want_j, want_p in zip(r[name], jax_ps, port_ps):
            _close(got, want_j)
            _close(got, want_p)


@pytest.mark.parametrize("dp", [2, 4])
def test_overflow_skips_everywhere(dp, request):
    for r in request.getfixturevalue(f"w{dp}"):
        p, st2, st = r["overflow"]
        _close(p, _t(_params(0)), 0, 0)
        assert int(st2["step"]) == 0
        assert all(torch.equal(st2[k], st[k]) for k in ("m", "v", "master"))


@pytest.mark.parametrize("dp", [2, 4])
def test_state_is_sharded_at_rest(dp, request):
    """Between two chained steps a rank holds its (R/dp, 128) rows of
    the state and no more, and the params are the bits of the route that
    gathers the state back."""
    for r in request.getfixturevalue(f"w{dp}"):
        held, shard_bytes, per_device, full, p = r["rest"]
        assert held == [(full[0] // dp, full[1])] * 2
        assert per_device == 3 * shard_bytes
        _close(p, r["adamw"][1], 0, 0)


@pytest.mark.parametrize("dp", [2, 4])
def test_grad_scale_unscales(dp, request):
    for r in request.getfixturevalue(f"w{dp}"):
        plain, scaled = r["scale"]
        _close(scaled, plain, 1e-5, 1e-7)


@pytest.mark.parametrize("dp", [2, 4])
def test_lamb_trust_ratio_spans_shards(dp, request):
    """A tensor bigger than one shard (emb: 16 flat rows) still gets ONE
    trust ratio: against the port's FusedLAMB, whose leaves are whole
    tensors, and the JAX optimizer."""
    want = _unsharded("lamb", dp, (4,), pseed=3, lr=5e-2)[0]
    want_j = _jax_steps("lamb", dp, (4,), pseed=3, lr=5e-2)[0]
    for r in request.getfixturevalue(f"w{dp}"):
        _close(r["trust"], want)
        _close(r["trust"], want_j)


@pytest.mark.parametrize("dp", [2, 4])
@pytest.mark.parametrize("cls", ["DistributedFusedAdam",
                                 "DistributedFusedLAMB"])
def test_bf16_moment_shard_tracks_fp32(cls, dp, request):
    for r in request.getfixturevalue(f"w{dp}"):
        p32, pbf, m_dtype, bytes_bf, bytes_32 = r[("bf16", cls)]
        assert m_dtype == torch.bfloat16
        assert bytes_bf * 12 == bytes_32 * 10
        _close(pbf, p32, 1e-3, 1e-4)


def test_unshardable_buffer_raises_the_reference_message():
    """A flat buffer whose rows do not split over dp fails at the
    layout, as in the reference."""
    ps.destroy_model_parallel()
    with pytest.raises(ValueError, match="not divisible by data-parallel "
                       "size 3"):
        DistributedFusedAdam(dp_size=3).init({"w": torch.zeros(4)})
    spec = DistributedFusedAdam(dp_size=2).partition_spec(tensor_axis="model")
    assert tuple(spec.master) == (("model", "data"), None)
    assert tuple(spec.step) == ()


# ---------------------------------------------------------------------------
# the sharded checkpoint
# ---------------------------------------------------------------------------

def _bits(a):
    """A host tensor or numpy array (ml_dtypes bf16 too) as unsigned
    integers of its width."""
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy().view(np.uint16)
        a = a.numpy()
    return np.ascontiguousarray(a).view({2: np.uint16, 4: np.uint32,
                                         8: np.uint64}[a.dtype.itemsize])


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


def _union(res, tag):
    """The ranks' sharded records merged: one {slice: block} a leaf."""
    merged = None
    for r in res:
        recs = [x for x in r["ckpt"][tag]["recs"] if x["kind"] == "sharded"]
        if merged is None:
            merged = [dict(shape=x["shape"], shards={}) for x in recs]
        for m, x in zip(merged, recs):
            assert m["shape"] == x["shape"]
            m["shards"].update(x["shards"])
    return merged


def _jax_save(st):
    import pickle
    import tempfile

    from apex_tpu.utils.checkpoint import save_sharded_checkpoint as jsave

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "zero.ckpt")
        jsave(path, st)
        with open(path, "rb") as f:
            return pickle.load(f)


@functools.lru_cache(maxsize=None)
def _jax_records(dp, tag):
    """The JAX package's ``save_sharded_checkpoint`` records after the
    reference's two steps (gradient seeds 0 and 1) on a dp-device mesh,
    the state device_put at rest as its test puts it."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as JP

    from apex_tpu.contrib import optimizers as jopt
    from apex_tpu.transformer import parallel_state as jps

    mesh = jps.initialize_model_parallel(devices=jax.devices()[:dp])
    try:
        opt = jopt.DistributedFusedAdam(
            lr=LR, weight_decay=0.01, dp_size=dp,
            m_dtype=jnp.bfloat16 if tag == "bf16m" else jnp.float32)
        params = _params(0)
        sspec = opt.partition_spec()
        st = jax.tree_util.tree_map(
            lambda a, s: jax.device_put(a, NamedSharding(mesh, s))
            if getattr(a, "ndim", 0) else a, opt.init(params), sspec)
        pspec = jax.tree.map(lambda _: JP(), params)
        step = jax.jit(jps.shard_map(
            lambda g, p, s: opt.step(g, p, s),
            in_specs=(jax.tree.map(lambda _: JP(jps.DATA_AXIS), params),
                      pspec, sspec), out_specs=(pspec, sspec)))
        for seed in (0, 1):
            params, st = step(_grads(seed, 0, dp), params, st)
        return _jax_save(st)
    finally:
        jps.destroy_model_parallel()


def _jax_records_of(dp, merged):
    """The JAX package's records of the port's own state: each leaf
    assembled from the ranks' blocks and device_put on a dp-device mesh
    with the rows over ``data``."""
    import jax
    import ml_dtypes
    from jax.sharding import NamedSharding, PartitionSpec as JP

    from apex_tpu.transformer import parallel_state as jps

    mesh = jps.initialize_model_parallel(devices=jax.devices()[:dp])
    try:
        leaves = []
        for m in merged:
            blocks = [m["shards"][k] for k in sorted(m["shards"])]
            whole = torch.cat(blocks)
            arr = _bits(whole).view(ml_dtypes.bfloat16) \
                if whole.dtype == torch.bfloat16 else whole.numpy()
            leaves.append(jax.device_put(
                arr, NamedSharding(mesh, JP(jps.DATA_AXIS, None))))
        return _jax_save(leaves)
    finally:
        jps.destroy_model_parallel()


def _check_ckpt(dp, res, tag):
    full_rows = res[0]["rest"][3][0]
    for r in res:
        c = r["ckpt"][tag]
        sharded = [x for x in c["recs"] if x["kind"] == "sharded"]
        dense = [x for x in c["recs"] if x["kind"] == "dense"]
        assert len(sharded) == 3   # master, m, v (step is dense)
        assert len(dense) == 1 and int(dense[0]["array"]) == 2
        for x in sharded:
            assert len(x["shards"]) == 1
            (block,) = x["shards"].values()
            assert block.shape[0] == x["shape"][0] // dp == full_rows // dp
        # the resumed third step: the uninterrupted one's bits
        _close(c["got"], c["want"], 0, 0)
    merged = _union(res, tag)
    jrecs = [x for x in _jax_records(dp, tag) if x["kind"] == "sharded"]
    # the port's records in the JAX package's layout: the same slices
    # (the JAX flat state's leaves: master, m, v) ...
    assert [sorted(m["shards"]) for m in merged] == \
        [sorted(j["shards"]) for j in jrecs]
    # ... the values of the same two steps within the ZeRO tolerance (m
    # in bf16 within one of its ulps) ...
    for m, j, tol in zip(merged, jrecs, (2e-5, 2.0 ** -7, 2e-5)):
        for k, block in m["shards"].items():
            assert str(block.dtype).split(".")[-1] == str(j["shards"][k].dtype)
            np.testing.assert_allclose(_f32(block), _f32(j["shards"][k]),
                                       rtol=tol if tag == "bf16m" else 2e-5,
                                       atol=1e-6)
    # ... and the JAX package's own records of the port's state hold the
    # ranks' blocks bit for bit, under the same slices
    for m, j in zip(merged, _jax_records_of(dp, merged)):
        assert sorted(m["shards"]) == sorted(j["shards"])
        for k, block in m["shards"].items():
            np.testing.assert_array_equal(_bits(block),
                                          _bits(j["shards"][k]))


@pytest.mark.parametrize("dp", [2, 4])
def test_sharded_checkpoint_resume(dp, request):
    """ZeRO save and resume without un-sharding: each rank's file holds
    its one block (R/dp rows) of master, m and v and a dense step; the
    blocks' union is the JAX package's record of the same steps; the
    resumed third step is the uninterrupted one, bit for bit."""
    _check_ckpt(dp, request.getfixturevalue(f"w{dp}"), "fp32")


@pytest.mark.parametrize("dp", [2, 4])
def test_sharded_checkpoint_roundtrip_bf16_m(dp, request):
    """A bf16 first moment stays bf16 through save and load, the loaded
    m is the saved bits, and the resumed step is the uninterrupted one's
    bits."""
    res = request.getfixturevalue(f"w{dp}")
    for r in res:
        assert r["ckpt"]["bf16m"]["m_dtype"] == torch.bfloat16
        assert r["ckpt"]["bf16m"]["m_equal"]
    _check_ckpt(dp, res, "bf16m")


@pytest.mark.parametrize("dp", [2, 4])
def test_sharded_checkpoint_refuses_another_topology(dp, request):
    """A file whose slices do not cover this rank's block raises the
    reference's message and gathers nothing."""
    for r in request.getfixturevalue(f"w{dp}"):
        assert r["mismatch"] is not None
        assert "resume topology mismatch" in r["mismatch"]

"""Port parity of ``contrib/optimizers`` (ZeRO: ``DistributedFusedAdam``
and ``DistributedFusedLAMB``) against the JAX package on the CPU.

The reference's ``test_distributed_optimizers.py`` cases but its two
sharded-checkpoint ones (they wait for ``utils/checkpoint.py``), at dp 2
and dp 4 gloo ranks (``tests/_torch_ranks.py``), each rank stepping
inside the port's ``parallel_state.shard_map`` on its own gradients and
its rows of the state: two steps against the JAX optimizer on a dp-device
mesh and against the port's unsharded ``FusedAdam`` / ``FusedLAMB`` on
the rank-mean gradients (2e-5 relative, 1e-6 absolute, the reference's);
an overflow on one rank skips the step on every rank; the state is split
at rest (a rank's rows 1/dp of the buffer, ``state_bytes_per_device``
three times their bytes); ``grad_scale`` unscales; LAMB's trust ratio
spans the split; a bf16 first moment (the state's bytes 10/12 of fp32's,
the params within 1e-3 / 1e-4 of the fp32 run). The params and the
per-rank gradients are the reference's draws, carried across as numpy.
This module imports no JAX at its top."""

import functools
import os

import numpy as np
import pytest
import torch

from _torch_ranks import spawn
from apex_tpu_torch.contrib.optimizers import (
    DistributedFusedAdam, DistributedFusedLAMB,
)
from apex_tpu_torch.optimizers import FusedAdam, FusedLAMB
from apex_tpu_torch.transformer import parallel_state as ps
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
    # the state at rest: this rank's rows
    m_rows = ps.shard_leaf(st.m, opt.partition_spec().m)
    out["rest"] = (tuple(m_rows.shape), m_rows.numel() * 4,
                   opt.state_bytes_per_device(d["params"][0]),
                   tuple(st.m.shape))
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
                "grads": {s: _t(_grads(s, {1: 0, 2: 0, 4: 3, 10: 0, 11: 0,
                                           40: 5, 41: 5}[s], world))
                          for s in (1, 2, 4, 10, 11, 40, 41)}},
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
    for r in request.getfixturevalue(f"w{dp}"):
        rows, shard_bytes, per_device, full = r["rest"]
        assert rows == (full[0] // dp, full[1])
        assert per_device == 3 * shard_bytes


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

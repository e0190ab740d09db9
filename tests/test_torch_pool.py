"""Port parity for the pool serving tier (``apex_tpu_torch.serving.
router``'s ``PoolRouter`` and ``serving.transfer``'s ``PageReshard``)
against the JAX package on the CPU.

Every case of ``tests/L0/run_serving/test_pool.py`` runs on the port
(``gpt_tiny`` with RoPE, the params carried across by
``params_from_jax``; replicas of 2 slots, max_len 32, pages of 4,
buckets (16, 32), one shared injector and live ``Tracer``, audited every
tick) and is held to the reference's contract against the port's own
colocated golden: pool streams at 1x1, 2x1 and 2x2 equal the colocated
scheduler's and the pair router's, the reshard tier's faults degrade to
host staging and colocated service without touching a stream, a
``pool_route`` fault moves placement only, and N-way failover (decode
sibling, borrowed prefill replica, last replica standing, the move
home) resumes bit for bit. Then the same schedule runs on the JAX
package (once a module) and the streams, outcomes, ``ServingStats``,
``injector.counts``, the registry's Prometheus text (reshard and
transfer counters, routing counters, load and health gauges), the
health ladders, the active replica and ``tracer.tick_stream()`` are
equal.

``eos_id=-1`` throughout. The port runs on one CPU thread, and the JAX
engines share their jitted step functions (the module's fixtures).
"""

import dataclasses
import functools
import importlib

import jax
import numpy as np
import pytest
import torch

from apex_tpu import serving as jax_serving
from apex_tpu.models import gpt as jax_gpt
from apex_tpu_torch import serving as S
from apex_tpu_torch.models import gpt as port_gpt

EOS = -1
MAX_LEN = 32
SEEDS = (0, 1, 2)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# The JAX engines' jitted step functions depend only on their factory's
# arguments (the config, compute dtype and quantization). Built once for
# the module, not once an engine, each reference run traces and compiles
# only what no earlier run of the module did; the functions are the JAX
# package's own.
_JAX_FACTORIES = {
    "apex_tpu.serving.scheduler": (
        "make_paged_prefill_fn", "make_paged_chunk_prefill_fn",
        "make_paged_decode_fn", "make_paged_verify_fn",
        "make_paged_tree_verify_fn", "make_copy_page_fn",
        "make_extract_pages_fn", "make_insert_pages_fn"),
    "apex_tpu.serving.router": ("make_insert_pages_fn",),
    "apex_tpu.serving.transfer": ("make_extract_pages_fn",),
}


@pytest.fixture(scope="module", autouse=True)
def _jax_fns_once():
    memo = {}
    with pytest.MonkeyPatch.context() as mp:
        for mod, names in _JAX_FACTORIES.items():
            m = importlib.import_module(mod)
            for name in names:
                f = getattr(m, name)
                mp.setattr(m, name, memo.setdefault(f, functools.cache(f)))
        yield


@pytest.fixture(scope="module")
def model():
    jcfg = dataclasses.replace(jax_gpt.gpt_tiny(), use_rope=True,
                               hidden_dropout=0.0)
    pcfg = dataclasses.replace(port_gpt.gpt_tiny(), use_rope=True,
                               hidden_dropout=0.0)
    jp = jax_gpt.init_gpt(jax.random.PRNGKey(0), jcfg)
    pp = port_gpt.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, jp, pcfg, pp


@pytest.fixture(scope="module")
def jax_runs():
    return {}


def _engine(model, mod, injector=None, tracer=None, num_pages=20, **kw):
    jcfg, jp, pcfg, pp = model
    kw.setdefault("tracer", tracer if tracer is not None else mod.Tracer())
    if mod is S:
        kw["device"] = "cpu"
    cfg, params = (pcfg, pp) if mod is S else (jcfg, jp)
    return mod.PagedDecodeEngine(params, cfg, num_slots=2, max_len=MAX_LEN,
                                 num_pages=num_pages, page_size=4,
                                 buckets=(16, 32), injector=injector, **kw)


_REQS = (dict(prompt=(1, 2, 3, 4, 5), max_new_tokens=8),
         dict(prompt=(6, 7, 8), max_new_tokens=6, temperature=0.8, seed=7),
         dict(prompt=(9, 10, 11, 12), max_new_tokens=4, temperature=1.1,
              seed=5))
_DEDUP = (dict(prompt=(1, 2, 3, 4, 5), max_new_tokens=6),
          dict(prompt=(1, 2, 3, 4, 9), max_new_tokens=6, temperature=0.8,
               seed=7))


def _drive(sched, mod, reqs=_REQS):
    for r in reqs:
        sched.submit(mod.Request(**r))
    with torch.inference_mode():
        return sched.run()


def _golden(model, reqs=_REQS, spec_k=0):
    eng = _engine(model, S, spec_k=spec_k)
    return _drive(S.ContinuousBatchingScheduler(eng, eos_id=EOS, audit=True),
                  S, reqs)


def _pool(model, mod, shape=(2, 2), schedule=None, rates=None, seed=0,
          spec_k=0, reqs=_REQS, **kw):
    """The reference's chaos pool on ``mod``, driven to the end."""
    inj = mod.FaultInjector(seed=seed, rates=rates, schedule=schedule)
    trc = mod.Tracer()
    prefills = [_engine(model, mod, inj, trc, spec_k=spec_k)
                for _ in range(shape[0])]
    decodes = [_engine(model, mod, inj, trc, spec_k=spec_k)
               for _ in range(shape[1])]
    pool = mod.PoolRouter(prefills, decodes, EOS, audit=True, **kw)
    _drive(pool, mod, reqs)
    return pool


_RATES = {"reshard_send": 0.25, "reshard_recv": 0.2, "pool_route": 0.15,
          "replica_health": 0.1, "page_send": 0.1, "decode_exec": 0.05}
_SCENARIOS = {
    **{f"fault_free_{p}x{d}_spec{k}": dict(shape=(p, d), spec_k=k)
       for p, d in ((1, 1), (2, 1), (2, 2)) for k in (0, 2)},
    "host_staged": dict(use_reshard=False),
    "dedup": dict(reqs=_DEDUP),
    "reshard_send": dict(schedule={"reshard_send": (0,)}),
    "reshard_recv": dict(schedule={"reshard_recv": (0,)}),
    "reshard_exhausted": dict(schedule={"reshard_send": (0, 1, 2)}),
    "pool_route": dict(schedule={"pool_route": (0,)}),
    "decode_down": dict(schedule={"replica_health": (2, 6)}),
    "all_decode_down": dict(schedule={"replica_health": (2, 6, 3, 7)}),
    "all_down": dict(schedule={"replica_health": tuple(range(0, 96))}),
    # prefill1 on another slice: its handoffs priced at the DCN rate
    "placement": dict(placement={"prefill1": 1}, ici_ticks_per_page=0.5,
                      dcn_ticks_per_page=1.5),
    **{f"chaos_seed{s}": dict(rates=_RATES, seed=s) for s in SEEDS},
}


def _summary(pool):
    """What a pool run must replay, and equal on both packages."""
    return dict(
        outcomes={rid: (tuple(o.tokens), o.reason, o.retries,
                        type(o.error).__name__, o.ttft_ticks,
                        o.total_ticks, o.prefill_ticks)
                  for rid, o in sorted(pool.outcomes.items())},
        stats=pool.stats.as_dict(),
        counts=pool.engine.injector.counts,
        ticks=pool.tracer.tick_stream(),
        metrics=pool.tracer.registry.to_prometheus(),
        health={n: (h.state, h.transitions)
                for n, h in sorted(pool.health.items())},
        active=pool.engine.active_name, clock=pool.clock)


def _run(model, jax_runs, name):
    """The scenario on the port; its JAX run (made once a module) must
    give the same summary. Returns the port's pool."""
    pool = _pool(model, S, **_SCENARIOS[name])
    if name not in jax_runs:
        jax_runs[name] = _summary(_pool(model, jax_serving,
                                        **_SCENARIOS[name]))
    got, want = _summary(pool), jax_runs[name]
    for key in want:
        assert got[key] == want[key], f"{name}: {key} differs from JAX"
    return pool


def _assert_all_ok_golden(pool, golden):
    assert sorted(pool.outcomes) == list(range(len(golden)))
    for rid, out in pool.outcomes.items():
        assert out.reason in S.FINISH_REASONS and out.ok
        assert list(out.tokens) == golden[rid], f"request {rid} diverged"


# -- fault-free identity across pool shapes -----------------------------------

@pytest.mark.parametrize("shape", [(1, 1), (2, 1), (2, 2)])
@pytest.mark.parametrize("spec_k", [0, 2])
def test_fault_free_pool_streams_match_colocated(model, jax_runs, shape,
                                                 spec_k):
    """At every shape, speculation off and on: the colocated streams,
    every admission remote over the reshard tier (no host staging)."""
    golden = _golden(model, spec_k=spec_k)
    pool = _run(model, jax_runs,
                f"fault_free_{shape[0]}x{shape[1]}_spec{spec_k}")
    assert pool.run() == golden
    assert pool.stats.remote_prefills == len(_REQS)
    assert pool.stats.colocated_prefills == 0
    assert pool.stats.reshards == len(_REQS)
    assert pool.stats.transfers == 0
    assert pool.stats.failovers == 0
    assert all(h.state == "healthy" for h in pool.health.values())
    _assert_all_ok_golden(pool, golden)


def test_pool_matches_pair_router_streams(model):
    """The 2x2 pool's streams and outcomes are the 1x1 pair router's."""
    inj, trc = S.FaultInjector(), S.Tracer()
    pair = S.DisaggregatedRouter(_engine(model, S, inj, trc),
                                 _engine(model, S, inj, trc), EOS,
                                 audit=True)
    pair_streams = _drive(pair, S)
    pool = _pool(model, S)
    assert pool.run() == pair_streams
    assert {r: o.tokens for r, o in pool.outcomes.items()} \
        == {r: o.tokens for r, o in pair.outcomes.items()}


def test_host_staged_pool_matches_reshard_pool(model, jax_runs):
    """``use_reshard=False`` pins the pool to the host-staged channel;
    the streams are the same."""
    golden = _golden(model)
    host = _run(model, jax_runs, "host_staged")
    assert host.run() == golden
    assert host.stats.transfers == len(_REQS)
    assert host.stats.reshards == 0


def test_cross_replica_prefix_dedup_pool_wide(model, jax_runs):
    golden = _golden(model, _DEDUP)
    pool = _run(model, jax_runs, "dedup")
    assert pool.run() == golden
    assert pool.stats.transfer_pages_deduped == 1
    assert pool.stats.remote_prefills == 2


def test_link_placement_prices_the_handoff(model, jax_runs):
    """``placement`` puts prefill1 on another slice: its handoffs are
    priced at the DCN rate, prefill0's at the ICI rate, and the clock
    and transfer histograms are the JAX package's; the streams do not
    move."""
    golden = _golden(model)
    pool = _run(model, jax_runs, "placement")
    _assert_all_ok_golden(pool, golden)
    assert pool.clock != _pool(model, S).clock
    with pytest.raises(ValueError, match="placement names unknown"):
        _pool(model, S, placement={"prefill9": 1})


# -- one pinned fault a site --------------------------------------------------

def test_reshard_send_fault_retries_to_golden(model, jax_runs):
    golden = _golden(model)
    pool = _run(model, jax_runs, "reshard_send")
    assert pool.stats.reshard_retries == 1
    assert pool.stats.reshard_failures == 0
    assert pool.stats.remote_prefills == len(_REQS)
    _assert_all_ok_golden(pool, golden)


def test_reshard_recv_corruption_quarantines_to_golden(model, jax_runs):
    golden = _golden(model)
    pool = _run(model, jax_runs, "reshard_recv")
    assert pool.stats.reshard_corrupt == 1
    assert pool.stats.reshard_retries == 1
    assert pool.stats.reshard_failures == 0
    _assert_all_ok_golden(pool, golden)


def test_reshard_exhaustion_degrades_to_host_staged(model, jax_runs):
    """Every attempt of the first reshard dropped: ReshardFailed is
    caught and the same pages re-ship host-staged; the admission stays
    remote and the stream golden."""
    golden = _golden(model)
    pool = _run(model, jax_runs, "reshard_exhausted")
    assert pool.stats.reshard_failures == 1
    assert pool.stats.transfers >= 1
    assert pool.stats.remote_prefills == len(_REQS)
    assert pool.stats.colocated_prefills == 0
    assert "failover" in [e.name for e in pool.tracer.events]
    _assert_all_ok_golden(pool, golden)


def _typed_exhaustion(model, mod):
    inj = mod.FaultInjector(schedule={"reshard_send": (0, 1, 2)})
    src = _engine(model, mod, inj)
    with torch.inference_mode():
        src.prefill(0, [1, 2, 3, 4, 5])
    reshard = mod.PageReshard(injector=inj, tracer=src.tracer,
                              stats=src.stats, max_retries=2)
    with pytest.raises(mod.ReshardFailed) as ei:
        reshard.ship(src, [1, 2, 3, 4, 5], src._slot_pages[0],
                     replica="prefill0")
    err = ei.value
    k_tile, _, attempts = reshard.ship(src, [1, 2, 3, 4, 5],
                                       src._slot_pages[0],
                                       replica="prefill0")
    return err, src, k_tile.shape, attempts


def test_reshard_exhaustion_is_typed(model):
    """Persistent drops exhaust the reshard budget with a typed
    ReshardFailed carrying the JAX package's attempts, pages and
    ``corrupt``; a clean channel then ships; sub-meshes over the same
    ranks build, over overlapping ones raise, and over disjoint ones
    need the default process group (the channel between processes,
    ``tests/test_torch_handoff.py``)."""
    err, src, shape, attempts = _typed_exhaustion(model, S)
    jerr, jsrc, jshape, jattempts = _typed_exhaustion(model, jax_serving)
    assert (err.attempts, err.pages, err.corrupt) \
        == (jerr.attempts, jerr.pages, jerr.corrupt) == (3, 2, False)
    assert isinstance(err, S.TransferFailed)
    assert src.stats.as_dict() == jsrc.stats.as_dict()
    assert src.stats.reshard_failures == 1 and src.stats.reshards == 1
    assert attempts == jattempts == 1 and tuple(shape) == tuple(jshape)
    from apex_tpu_torch.transformer.parallel_state import Mesh

    def mesh(ranks):
        return Mesh(np.asarray(ranks).reshape(1, 1, 1, -1), None, {})

    with pytest.raises(ValueError, match="disjoint"):
        S.PageReshard(src_mesh=mesh([0, 1]), dst_mesh=mesh([1, 2]))
    with pytest.raises(RuntimeError, match="default process group"):
        S.PageReshard(src_mesh=mesh([0, 1]), dst_mesh=mesh([2, 3]))
    assert S.PageReshard(src_mesh=mesh([0, 1]),
                         dst_mesh=mesh([1, 0])).recv_site == "reshard_recv"


def test_pool_route_fault_falls_back_fixed_order(model, jax_runs):
    golden = _golden(model)
    pool = _run(model, jax_runs, "pool_route")
    assert pool.stats.route_fallbacks == 1
    assert pool.stats.remote_prefills == len(_REQS)
    _assert_all_ok_golden(pool, golden)


# -- N-way failover -----------------------------------------------------------

def test_active_decode_down_fails_over_to_sibling(model, jax_runs):
    """decode0 dies (probe order prefill0, prefill1, decode0, decode1 a
    tick): the slots move to its decode sibling, never a prefill borrow
    while a sibling is routable."""
    golden = _golden(model)
    pool = _run(model, jax_runs, "decode_down")
    assert pool.stats.failovers == 1
    assert pool.stats.rebalances == 1
    assert pool.engine.active_name == "decode1"
    names = [e.name for e in pool.tracer.events]
    assert "rebalance" in names and "preempted" in names
    _assert_all_ok_golden(pool, golden)


def test_all_decode_down_borrows_prefill_then_rebalances_home(model,
                                                              jax_runs):
    """Both decode replicas die: the slots borrow a prefill replica,
    then move home once a decode replica climbs back."""
    golden = _golden(model)
    pool = _run(model, jax_runs, "all_decode_down")
    assert pool.stats.failovers >= 1
    assert pool.stats.rebalances >= 2
    assert pool.engine.active_name in pool.engine.decode_names
    _assert_all_ok_golden(pool, golden)


def test_all_replicas_down_last_standing_keeps_serving(model, jax_runs):
    golden = _golden(model)
    pool = _run(model, jax_runs, "all_down")
    assert pool.stats.failovers == 0
    assert pool.stats.colocated_prefills >= 1
    assert all(h.state == "down" for h in pool.health.values())
    _assert_all_ok_golden(pool, golden)


# -- construction contracts ---------------------------------------------------

def _refusals(model, mod):
    jcfg, jp, pcfg, pp = model
    inj, trc = mod.FaultInjector(), mod.Tracer()

    def eng(**kw):
        return _engine(model, mod, kw.pop("injector", inj),
                       kw.pop("tracer", trc), **kw)

    cfg, params = (pcfg, pp) if mod is S else (jcfg, jp)
    dev = {"device": "cpu"} if mod is S else {}
    tier = mod.PrefixRegistry(capacity_bytes=1 << 20)
    e = eng()
    cases = [
        lambda: mod.PoolRouter([eng(), eng()], [eng(), mod.PagedDecodeEngine(
            params, cfg, num_slots=2, max_len=MAX_LEN, num_pages=20,
            page_size=8, buckets=(16, 32), injector=inj, tracer=trc,
            **dev)], EOS),
        lambda: mod.PoolRouter([eng(host_tier=tier), eng()],
                               [eng(host_tier=tier), eng(host_tier=tier)],
                               EOS),
        lambda: mod.PoolRouter([e, eng()], [eng(), e], EOS),
        lambda: mod.PoolRouter([eng(injector=mod.FaultInjector()), eng()],
                               [eng(), eng()], EOS),
        lambda: mod.PoolRouter([eng(), eng()],
                               [eng(), eng(tracer=mod.Tracer())], EOS),
        lambda: mod.PoolRouter([eng()], [eng()], EOS, chunk_tokens=4),
        lambda: mod.PoolRouter([], [eng()], EOS),
        lambda: mod.PoolRouter([eng(), eng()], [eng(), eng()], EOS,
                               placement={"prefill9": 1}),
    ]
    out = []
    for case in cases:
        with pytest.raises(ValueError) as ei:
            case()
        out.append(str(ei.value))
    return out


def test_pool_validates_replicas_pool_wide(model):
    """Both packages refuse the same pools with the same messages: a
    mixed geometry caught pairwise, split host tiers, a repeated
    engine, split injectors or tracers, chunked prefill, an empty role,
    an unknown placement name."""
    got = _refusals(model, S)
    assert got == _refusals(model, jax_serving)
    for msg, want in zip(got, ("agree on page_size", "ONE PrefixRegistry",
                               "two engine instances", "ONE FaultInjector",
                               "ONE Tracer", "chunked prefill",
                               "at least one", "placement names unknown")):
        assert want in msg


# -- the randomized multi-fault sweep -----------------------------------------

@pytest.mark.parametrize("seed", SEEDS)
def test_multi_fault_pool_chaos_replays_bit_for_bit(model, jax_runs, seed):
    """Every pool site armed at once (reshard drop and corruption,
    routing, health, host-staged drops, decode faults), audited every
    tick: typed outcomes, ok streams golden, degraded ones golden
    prefixes; the run replays exactly and equals the JAX package's."""
    golden = _golden(model)
    pool = _run(model, jax_runs, f"chaos_seed{seed}")
    assert sorted(pool.outcomes) == list(range(len(_REQS)))
    for rid, out in pool.outcomes.items():
        assert out.reason in S.FINISH_REASONS
        want = golden[rid]
        if out.ok:
            assert list(out.tokens) == want, f"request {rid} diverged"
        else:
            assert list(out.tokens) == want[:len(out.tokens)]
    replay = _pool(model, S, **_SCENARIOS[f"chaos_seed{seed}"])
    assert _summary(replay) == _summary(pool)

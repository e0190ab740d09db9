"""Port parity for the multi-tenant streaming front end
(``apex_tpu_torch.serving.tenancy`` and ``serving.streaming``) against
the JAX package on the CPU: the single-engine cases of
``tests/L0/run_serving/test_tenancy.py`` on ``gpt_tiny`` with RoPE (2
slots, max_len 32, pages of 4, the params carried across by
``params_from_jax``), each held to the reference's contract:

- tenancy moves WHEN work runs, never WHAT commits: plain, speculative
  and chunked tenanted streams equal the untenanted scheduler's, and
  every ``TokenStream`` delivered them whole;
- a ``stream_emit`` fault closes its stream with a typed
  ``StreamFailed``, the delivered tokens a strict prefix of the
  committed ones, the request itself untouched;
- quotas: typed ``QuotaExhausted`` at submit, deferral under pressure,
  the books back at zero; weighted shares converge to the weights on
  the tick clock; a higher rung preempts a lower one; ``SloViolation``
  is stamped with ``ok`` untouched;
- the multi-fault tenant chaos replays exactly, and on its first seed
  the outcomes, stats, injector counts, tick stream, the tenant gauges
  and the stream mux's ``snapshot()`` equal the JAX scheduler's;
- the same identity and strict-prefix delivery through the
  ``PoolRouter`` (two prefill replicas, one decode replica, one shared
  injector and tracer), the pool's ``stream_emit`` chaos equal to the
  JAX pool's.

The port runs on one CPU thread (the module's fixture).
"""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from apex_tpu import serving as jax_serving
from apex_tpu.models import gpt as jax_gpt
from apex_tpu.serving import tenancy as jax_tenancy
from apex_tpu_torch import serving as S
from apex_tpu_torch.models import gpt as port_gpt

#: The tenant chaos sweep's seeds; the CI chaos matrix overrides them
#: with ``APEX_CHAOS_TENANT_SEED`` (comma-separated ints), the reference's
#: variable (``tests/L0/run_serving/test_tenancy.py``).
_TENANT_SEEDS = tuple(
    int(s) for s in os.environ.get("APEX_CHAOS_TENANT_SEED",
                                   "0,1,2").split(","))

EOS = -1
MAX_LEN = 32


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    jcfg = dataclasses.replace(jax_gpt.gpt_tiny(), use_rope=True,
                               hidden_dropout=0.0)
    pcfg = dataclasses.replace(port_gpt.gpt_tiny(), use_rope=True,
                               hidden_dropout=0.0)
    jp = jax_gpt.init_gpt(jax.random.PRNGKey(0), jcfg)
    pp = port_gpt.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, jp, pcfg, pp


def _engine(model, injector=None, num_pages=24, **kw):
    _, _, cfg, params = model
    kw.setdefault("tracer", S.Tracer())
    return S.PagedDecodeEngine(params, cfg, num_slots=2, max_len=MAX_LEN,
                               num_pages=num_pages, page_size=4,
                               buckets=(16, 32), injector=injector,
                               device="cpu", **kw)


def _tenants(mod):
    return (mod.Tenant("interactive", weight=3.0, priority=1),
            mod.Tenant("batch", weight=1.0))


def _reqs(mod):
    return [mod.Request(prompt=(1, 2, 3, 4, 5), max_new_tokens=8,
                        tenant_id="interactive"),
            mod.Request(prompt=(6, 7, 8), max_new_tokens=6,
                        temperature=0.8, seed=7, tenant_id="batch"),
            mod.Request(prompt=(9, 10, 11, 12), max_new_tokens=4,
                        temperature=1.1, seed=5, tenant_id="interactive")]


_REQS = _reqs(S)


def _drive(sched, reqs=_REQS):
    for r in reqs:
        sched.submit(r)
    with torch.inference_mode():
        return sched.run()


def _golden(model, reqs=_REQS, spec_k=0, chunk=None):
    """Untenanted, unstreamed committed streams."""
    eng = _engine(model, spec_k=spec_k)
    return _drive(S.ContinuousBatchingScheduler(
        eng, eos_id=EOS, audit=True, chunk_tokens=chunk), reqs)


def _tenanted(model, injector=None, tenants=None, spec_k=0, chunk=None,
              num_pages=24, **skw):
    eng = _engine(model, injector, num_pages=num_pages, spec_k=spec_k)
    return S.ContinuousBatchingScheduler(
        eng, eos_id=EOS, audit=True, chunk_tokens=chunk,
        tenancy=S.TenancyPolicy(_tenants(S) if tenants is None
                                else tenants), streams=True, **skw)


# -- the policy alone ---------------------------------------------------------

def test_policy_books_equal_jax():
    """The policy's host state machine gives the JAX policy's selection
    keys, vtimes, quota answers, SLO verdicts and gauges on the same
    sequence of calls, and refuses the reference's bad configs."""
    def drive(mod):
        pol = mod.TenancyPolicy((
            mod.Tenant("a", weight=2.0, page_quota=6, priority=1,
                       ttft_slo_ticks=3, itl_slo_ticks=2),
            mod.Tenant("b", weight=0.5)))
        log = [pol.needs_quota, sorted(pol.tenants)]
        for t, n in (("a", 3), ("b", 2), ("default", 1)):
            pol.note_enqueued(t)
            pol.charge_tokens(t, n)
        log += [pol.selection_key(t, c) for t in ("a", "b", "default")
                for c in (True, False)]
        log += [pol.fits_quota("a", 6), pol.fits_quota("a", 7),
                pol.charge_admission(0, "a", 4), pol.can_admit(1, "a", 3),
                pol.can_admit(0, "a", 9), pol.charged_total()]
        for v in ((5, None), (2, 3), (None, 1), (1, 1)):
            slo = pol.slo_check("a", *v)
            log.append(None if slo is None else (slo.metric, slo.observed,
                                                 slo.bound, str(slo)))
        pol.credit(0)
        pol.note_finished("a")
        pol.note_enqueued("a")
        log += [pol.vtime(t) for t in ("a", "b", "default")]
        log += [pol.gauge_snapshot(), repr(pol), pol.charged_total()]
        return log

    assert drive(S) == drive(jax_tenancy)
    assert S.DEFAULT_TENANT == jax_tenancy.DEFAULT_TENANT
    for kw in (dict(name=""), dict(name="x", weight=0.0),
               dict(name="x", page_quota=0)):
        with pytest.raises(ValueError):
            S.Tenant(**kw)
    with pytest.raises(ValueError, match="duplicate"):
        S.TenancyPolicy([S.Tenant("x"), S.Tenant("x")])
    with pytest.raises(ValueError, match="underflow"):
        S.TenancyPolicy().note_finished("default")


def test_stream_mux_alone():
    """Staging, flush order, strict-prefix drops and the sink, against
    the JAX mux on the same calls under a pinned ``stream_emit``
    schedule."""
    def drive(mod):
        got = []
        mux = mod.StreamMux(injector=mod.FaultInjector(
            schedule={"stream_emit": (2,)}),
            sink=lambda rid, t, toks: got.append((rid, t, toks)))
        for rid in (0, 1, 2):
            mux.open(rid, "t%d" % rid)
        for tick in range(3):
            for rid in (2, 0, 1):
                mux.stage(rid, 10 * rid + tick)
            if tick == 1:
                mux.finish(1, "length")
            mux.flush()
        return (mux.snapshot(), got, [s.as_dict() for _, s in
                                      sorted(mux.streams.items())],
                mux.stats.as_dict(), mux.injector.counts)

    assert drive(S) == drive(jax_serving)


# -- bit identity: tenanted streams == untenanted committed streams ------------

@pytest.mark.parametrize("spec_k,chunk", [(0, None), (2, None), (0, 8)])
def test_tenanted_streams_bit_identical_to_untenanted(model, spec_k,
                                                      chunk):
    """Fair share, priority rungs and streaming change WHEN work runs:
    the committed streams equal the untenanted scheduler's, and every
    stream delivered the whole committed stream."""
    golden = _golden(model, spec_k=spec_k, chunk=chunk)
    sched = _tenanted(model, spec_k=spec_k, chunk=chunk)
    assert _drive(sched) == golden
    for rid, out in sorted(sched.outcomes.items()):
        assert out.ok and out.reason in S.FINISH_REASONS
        assert out.tenant_id == _REQS[rid].tenant_id
        st = sched.streams.streams[rid]
        assert st.closed and not st.failed
        assert st.delivered == golden[rid]
    assert sched.tenancy.charged_total() == 0
    assert sched.stats.stream_tokens == sum(len(g) for g in golden)


def test_pool_tenanted_streams_bit_identical(model):
    """The same identity through the pool tier: tenancy and streaming
    ride the PoolRouter's composite engine without moving a token."""
    golden = _golden(model)
    inj, trc = S.FaultInjector(), S.Tracer()
    pool = S.PoolRouter([_engine(model, inj, tracer=trc) for _ in range(2)],
                        [_engine(model, inj, tracer=trc)], EOS, audit=True,
                        tenancy=S.TenancyPolicy(_tenants(S)), streams=True)
    assert _drive(pool) == golden
    for rid, out in sorted(pool.outcomes.items()):
        assert out.ok and out.tenant_id == _REQS[rid].tenant_id
        assert pool.streams.streams[rid].delivered == golden[rid]
    assert pool.tenancy.charged_total() == 0
    assert pool.stats.remote_prefills == len(_REQS)


def _pool_emit_chaos(model, mod=S):
    """The reference's pool ``stream_emit`` chaos on either package."""
    jcfg, jp, _, _ = model
    inj, trc = mod.FaultInjector(seed=5, rates={"stream_emit": 0.5}), \
        mod.Tracer()
    if mod is S:
        engines = [_engine(model, inj, tracer=trc) for _ in range(3)]
    else:
        engines = [jax_serving.PagedDecodeEngine(
            jp, jcfg, num_slots=2, max_len=MAX_LEN, num_pages=24,
            page_size=4, buckets=(16, 32), injector=inj, tracer=trc)
            for _ in range(3)]
    pool = mod.PoolRouter(engines[:2], engines[2:], EOS, audit=True,
                          tenancy=mod.TenancyPolicy(_tenants(mod)),
                          streams=True)
    for r in _reqs(mod):
        pool.submit(r)
    with torch.inference_mode():
        pool.run()
    return pool


def test_stream_emit_chaos_on_pool(model):
    """The strict-prefix contract through the pool: the mux draws
    ``stream_emit`` on the pool's shared injector; the run replays
    exactly, and equals the JAX pool's (outcomes, stats, counts, tick
    stream, stream snapshots and deliveries)."""
    golden = _golden(model)
    pool = _pool_emit_chaos(model)
    assert pool.stats.stream_failures > 0
    for rid, out in sorted(pool.outcomes.items()):
        assert out.ok and list(out.tokens) == golden[rid]
        st = pool.streams.streams[rid]
        assert st.delivered == golden[rid][:len(st.delivered)]
    got = _tenant_summary(pool, [])
    assert _tenant_summary(_pool_emit_chaos(model), []) == got
    want = _tenant_summary(_pool_emit_chaos(model, jax_serving), [])
    for key in want:
        assert got[key] == want[key], key


# -- stream_emit chaos: strict-prefix delivery --------------------------------

@pytest.mark.parametrize("spec_k,chunk", [(0, None), (2, None), (0, 8)])
def test_stream_emit_chaos_delivers_strict_prefix(model, spec_k, chunk):
    """Dropped delivery batches close their stream with a typed
    ``StreamFailed``, its delivered tokens a STRICT prefix of the
    committed stream; the committed streams stay golden; exact
    replay."""
    golden = _golden(model, spec_k=spec_k, chunk=chunk)

    def chaos_run():
        sched = _tenanted(
            model, S.FaultInjector(seed=3, rates={"stream_emit": 0.4}),
            spec_k=spec_k, chunk=chunk)
        _drive(sched)
        return sched

    sched = chaos_run()
    assert sched.stats.stream_failures > 0
    failed = 0
    for rid, out in sorted(sched.outcomes.items()):
        assert out.ok, "a delivery fault must never fail the request"
        assert list(out.tokens) == golden[rid]
        st = sched.streams.streams[rid]
        assert st.closed
        assert st.delivered == golden[rid][:len(st.delivered)]
        if st.failed:
            failed += 1
            assert isinstance(st.error, S.StreamFailed)
            assert st.error.payload["request_id"] == rid
            assert len(st.delivered) < len(golden[rid])
    assert failed == sched.stats.stream_failures
    replay = chaos_run()
    assert replay.stats.as_dict() == sched.stats.as_dict()
    assert replay.engine.injector.counts == sched.engine.injector.counts
    assert replay.streams.snapshot() == sched.streams.snapshot()


# -- quotas, shares, priority, SLOs -------------------------------------------

def test_quota_exhausted_typed_and_leak_free(model):
    """A request that could never fit its tenant's quota raises typed
    ``QuotaExhausted`` at submit with the full payload and no id; two
    fitting requests are admitted one at a time under pressure; the
    books drain to zero."""
    sched = _tenanted(model, tenants=(S.Tenant("small", page_quota=4),))
    pol = sched.tenancy
    with pytest.raises(S.QuotaExhausted) as exc:
        sched.submit(S.Request(prompt=tuple(range(1, 10)),
                               max_new_tokens=12, tenant_id="small"))
    assert exc.value.payload == {"tenant": "small", "need": 6,
                                 "quota": 4, "charged": 0}
    assert sched.stats.quota_exhausted == 1
    assert sched.outcomes == {}
    sched.submit(S.Request(prompt=(1, 2, 3, 4, 5), max_new_tokens=8,
                           tenant_id="small"))
    sched.submit(S.Request(prompt=(6, 7, 8), max_new_tokens=8,
                           tenant_id="small"))
    with torch.inference_mode():
        streams = sched.run()
    assert len(streams) == 2
    assert all(out.ok for out in sched.outcomes.values())
    assert sched.stats.quota_deferrals >= 1
    assert pol.charged_total() == 0 and pol.ledger.charged("small") == 0
    for rid, st in sorted(sched.streams.streams.items()):
        assert st.delivered == streams[rid]
    with pytest.raises(ValueError):
        sched.submit(S.Request(prompt=(1, 2), max_new_tokens=2,
                               tenant_id="nobody"))
    _, _, cfg, params = model
    dense = S.DecodeEngine(params, cfg, num_slots=2, max_len=MAX_LEN,
                           device="cpu")
    with pytest.raises(ValueError, match="paged engine"):
        S.ContinuousBatchingScheduler(dense, eos_id=EOS, tenancy=(
            S.TenancyPolicy([S.Tenant("q", page_quota=4)])))


def test_weighted_shares_converge_on_tick_clock(model):
    """Two saturating tenants at weights 3:1: committed-token shares
    converge to the ratio while both stay backlogged, vtimes within one
    request's stride."""
    sched = _tenanted(model, num_pages=48,
                      tenants=(S.Tenant("heavy", weight=3.0),
                               S.Tenant("light", weight=1.0)))
    pol = sched.tenancy
    for i in range(16):
        sched.submit(S.Request(prompt=(1 + i, 2, 3), max_new_tokens=6,
                               tenant_id="heavy"))
        sched.submit(S.Request(prompt=(4, 5 + i, 6), max_new_tokens=6,
                               tenant_id="light"))
    with torch.inference_mode():
        for _ in range(36):
            sched.step()
        heavy, light = pol.tokens("heavy"), pol.tokens("light")
        assert light > 0
        assert 2.2 <= heavy / light <= 4.0
        assert abs(pol.vtime("heavy") - pol.vtime("light")) <= 6.5
        sched.run()
    assert len(sched.outcomes) == 32
    assert all(out.ok for out in sched.outcomes.values())
    assert pol.charged_total() == 0


def test_priority_preemption_requeues_resident_lower_rung(model):
    """A strictly higher waiting rung preempts a resident lower one; the
    paid request jumps the line and every stream stays golden."""
    reqs = [S.Request(prompt=(1, 2, 3, 4, 5), max_new_tokens=12,
                      tenant_id="free"),
            S.Request(prompt=(6, 7, 8), max_new_tokens=12,
                      tenant_id="free"),
            S.Request(prompt=(9, 10, 11, 12), max_new_tokens=6,
                      tenant_id="paid")]
    golden = _golden(model, reqs)
    sched = _tenanted(model, tenants=(S.Tenant("free", priority=0),
                                      S.Tenant("paid", priority=2)))
    sched.submit(reqs[0])
    sched.submit(reqs[1])
    with torch.inference_mode():
        for _ in range(3):
            sched.step()
        sched.submit(reqs[2])
        sched.run()
    assert sched.stats.tenant_preemptions >= 1
    for rid, out in sorted(sched.outcomes.items()):
        assert out.ok and list(out.tokens) == golden[rid]
        assert sched.streams.streams[rid].delivered == golden[rid]
    paid, = [o for o in sched.outcomes.values() if o.tenant_id == "paid"]
    free_ttfts = [o.ttft_ticks for o in sched.outcomes.values()
                  if o.tenant_id == "free"]
    assert paid.ttft_ticks <= min(free_ttfts) + 12


def test_slo_violations_typed_and_observable(model):
    """Tight bounds on an oversubscribed tenant: typed ``SloViolation``
    in ``RequestOutcome.slo`` with ``ok`` untouched, the counter, and
    the tracer's tenant latency summary."""
    sched = _tenanted(model, tenants=(
        S.Tenant("strict", ttft_slo_ticks=1, itl_slo_ticks=1),))
    reqs = [S.Request(prompt=(1 + i, 2, 3, 4), max_new_tokens=6,
                      tenant_id="strict") for i in range(4)]
    _drive(sched, reqs)
    viols = [o for o in sched.outcomes.values() if o.slo is not None]
    assert viols
    assert all(isinstance(o.slo, S.SloViolation) for o in viols)
    assert all(o.slo.metric in ("ttft", "itl") for o in viols)
    assert all(o.slo.observed > o.slo.bound for o in viols)
    assert all(o.ok for o in sched.outcomes.values())
    assert sched.stats.slo_violations == len(viols)
    summary = sched.tracer.tenant_latency_summary("strict")
    assert summary["ttft_p50"] >= 1 and summary["itl_p99"] >= 1


# -- randomized multi-fault sweep ---------------------------------------------

_CHAOS_RATES = {"stream_emit": 0.25, "pool_alloc": 0.1,
                "prefill_exec": 0.1, "decode_exec": 0.1, "sample": 0.1}


def _chaos_run(model, seed, mod=S):
    """The reference's tenant chaos run on either package; returns the
    scheduler and the tenant gauges after every tick."""
    jcfg, jp, _, _ = model
    inj = mod.FaultInjector(seed=seed, rates=_CHAOS_RATES)
    if mod is S:
        sched = _tenanted(model, inj, num_pages=16)
    else:
        eng = jax_serving.PagedDecodeEngine(
            jp, jcfg, num_slots=2, max_len=MAX_LEN, num_pages=16,
            page_size=4, buckets=(16, 32), injector=inj,
            tracer=jax_serving.Tracer())
        sched = jax_serving.ContinuousBatchingScheduler(
            eng, eos_id=EOS, audit=True,
            tenancy=jax_serving.TenancyPolicy(_tenants(jax_serving)),
            streams=True)
    for r in _reqs(mod):
        sched.submit(r)
    gauges = []
    with torch.inference_mode():
        while sched.busy:
            sched.step()
            gauges.append(sched.tenancy.gauge_snapshot())
    return sched, gauges


def _tenant_summary(sched, gauges):
    return dict(
        outcomes={rid: (tuple(o.tokens), o.reason, o.retries,
                        type(o.error).__name__, o.ttft_ticks,
                        o.total_ticks, o.prefill_ticks, o.tenant_id,
                        None if o.slo is None else o.slo.payload)
                  for rid, o in sorted(sched.outcomes.items())},
        stats=sched.stats.as_dict(), counts=sched.engine.injector.counts,
        ticks=sched.tracer.tick_stream(), gauges=gauges,
        streams=sched.streams.snapshot(),
        delivered={rid: st.delivered
                   for rid, st in sorted(sched.streams.streams.items())},
        prometheus=sched.tracer.registry.to_prometheus())


@pytest.mark.parametrize("seed", _TENANT_SEEDS)
def test_multi_fault_tenant_chaos_replays_bit_for_bit(model, seed):
    """Every serving-path site armed at once over the tenanted, streaming
    scheduler, audited every tick: typed outcomes, golden or
    golden-prefix streams, deliveries prefixes of their commits, the
    books at zero, and an exact replay (outcomes, stats, counts, stream
    snapshots, tick stream)."""
    golden = _golden(model)
    sched, gauges = _chaos_run(model, seed)
    assert sorted(sched.outcomes) == list(range(len(_REQS)))
    for rid, out in sorted(sched.outcomes.items()):
        assert out.reason in S.FINISH_REASONS
        want = golden[rid]
        if out.ok:
            assert list(out.tokens) == want, f"request {rid} diverged"
        else:
            assert list(out.tokens) == want[:len(out.tokens)]
        st = sched.streams.streams[rid]
        assert st.delivered == list(out.tokens)[:len(st.delivered)]
    assert sched.tenancy.charged_total() == 0
    assert _tenant_summary(*_chaos_run(model, seed)) \
        == _tenant_summary(sched, gauges)


def test_multi_fault_tenant_chaos_equals_jax(model):
    """The first seed of the tenant chaos on both packages: outcomes
    (with their SLO verdicts), stats, injector counts, the tick stream,
    the tenant gauges after every tick, the stream mux's ``snapshot()``
    and deliveries, and the Prometheus text are equal."""
    got = _tenant_summary(*_chaos_run(model, 0))
    want = _tenant_summary(*_chaos_run(model, 0, jax_serving))
    assert sum(got["counts"].values()) > 0
    for key in want:
        assert got[key] == want[key], key

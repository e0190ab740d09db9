"""Port parity for the serving tracer and metrics (``apex_tpu_torch.
serving.observe`` and ``health.ServingStats``) against the JAX
package's on the CPU: the fault-free cases of
``tests/L0/run_serving/test_observe.py``, each also held to the JAX
side on the same inputs.

- the metric math (histogram quantiles and cumulative ``le`` buckets,
  registry get-or-create and type conflicts) gives the JAX module's
  numbers and errors; the Prometheus text is the JAX text byte for byte;
- the flight recorder's ring is bounded; ``ServingStats`` is a view over
  the registry, its ``as_dict`` and ``snapshot`` the JAX ones;
- engines built without a tracer get an inert one (no events, the stats
  still counted) and tracing never perturbs the committed streams;
- on ``gpt_tiny`` (RoPE, fp32 cache, page size 4) the port's
  ``tick_stream()`` equals the JAX scheduler's event for event on plain,
  speculative, chunked and host-tier runs with no
  fault injector, and so do its registry (Prometheus text), its
  ``latency_summary()`` and its outcomes' tick fields; the Perfetto dump
  is the JAX dump up to the wall-clock fields;
- the disaggregated pair's and the 2x2 pool's spans, per-replica
  counters, histograms and gauges under a pinned fault schedule: their
  tick streams replay and equal the JAX package's, and so do their
  registries.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import serving as jax_serving
from apex_tpu.models import gpt as jax_gpt
from apex_tpu.serving import observe as jax_observe
from apex_tpu_torch import serving as port_serving
from apex_tpu_torch.models import gpt as port_gpt
from apex_tpu_torch.serving import health as port_health
from apex_tpu_torch.serving import observe as port_observe

EOS = -1
MAX_LEN = 32


@pytest.fixture(scope="module")
def model():
    jcfg = dataclasses.replace(jax_gpt.gpt_tiny(), use_rope=True,
                               hidden_dropout=0.0)
    pcfg = dataclasses.replace(port_gpt.gpt_tiny(), use_rope=True,
                               hidden_dropout=0.0)
    jp = jax_gpt.init_gpt(jax.random.PRNGKey(0), jcfg)
    pp = port_gpt.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, jp, pcfg, pp


# -- metric math --------------------------------------------------------------

def test_histogram_quantiles_match_jax_and_bruteforce():
    """The same seeded values give the JAX histogram's counts, sum and
    quantiles exactly, each within one bucket width of numpy's."""
    bounds = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0)
    rng = np.random.RandomState(42)
    vals = np.concatenate([rng.randint(1, 30, size=400),
                           rng.randint(30, 100, size=40)])
    hp = port_observe.Histogram("ttft", buckets=bounds)
    hj = jax_observe.Histogram("ttft", buckets=bounds)
    for v in vals:
        hp.observe(float(v))
        hj.observe(float(v))
    assert (hp.counts, hp.count, hp.sum) == (hj.counts, hj.count, hj.sum)
    edges = [float(vals.min()), *bounds, float(vals.max())]
    for q in (0.1, 0.5, 0.9, 0.95, 0.99):
        est = hp.quantile(q)
        assert est == hj.quantile(q)
        true = float(np.percentile(vals, q * 100))
        i = int(np.searchsorted(bounds, true, side="left"))
        width = edges[i + 1] - edges[i]
        assert abs(est - true) <= width + 1e-9
    assert hp.scalar() == hj.scalar()
    assert port_observe.Histogram("e").quantile(0.5) is None
    with pytest.raises(ValueError, match="ascending"):
        port_observe.Histogram("bad", buckets=(2.0, 1.0))


def test_histogram_bucket_counts_are_cumulative_le():
    """le semantics: a value equal to a bound lands in that bucket; the
    tail interpolates toward the observed max; the Prometheus buckets
    are cumulative."""
    h = port_observe.Histogram("h", buckets=(1.0, 2.0, 4.0))
    for v in (0.5, 1.0, 1.5, 2.0, 3.0, 100.0):
        h.observe(v)
    assert h.counts == [2, 2, 1, 1]
    assert h.quantile(0.0) is not None
    assert h.quantile(1.0) == 100.0
    r = port_observe.MetricsRegistry()
    r._metrics[("h", ())] = h
    assert [ln.split()[-1] for ln in r.to_prometheus().splitlines()
            if ln.startswith("h_bucket")] == ["2", "4", "5", "6"]


def test_registry_get_or_create_and_type_conflict():
    """Get-or-create by (name, labels); asking for a registered name as
    another kind raises the JAX registry's TypeError."""
    r = port_observe.MetricsRegistry()
    c = r.counter("x", help="h")
    assert r.counter("x") is c
    assert r.gauge("g", labels={"slot": 0}) \
        is not r.gauge("g", labels={"slot": 1})
    with pytest.raises(TypeError) as got:
        r.gauge("x")
    rj = jax_observe.MetricsRegistry()
    rj.counter("x", help="h")
    with pytest.raises(TypeError) as want:
        rj.gauge("x")
    assert str(got.value) == str(want.value)
    assert r.get("missing") is None and r.quantiles("x") is None


def _fill(mod):
    """One registry of each module with the same recorded values: every
    kind, labels, help text, an empty and a filled histogram."""
    r = mod.MetricsRegistry()
    r.counter("serving_retries_total", help="fault-path requeues").inc(3)
    r.gauge("serving_queue_depth").set(2)
    r.gauge("serving_stream_acceptance_rate", help="acc",
            labels={"slot": 1}).set(0.25)
    h = r.histogram("serving_ttft_ticks", buckets=(1.0, 4.0))
    h.observe(1.0)
    h.observe(9.0)
    r.histogram("serving_tenant_itl_ticks", labels={"tenant": "a"},
                help="per tenant").observe(3.5)
    r.histogram("serving_empty")
    return r


def test_prometheus_text_byte_for_byte_against_jax():
    """The same recorded values give the JAX exposition text byte for
    byte, and the same ``as_dict`` and ``quantiles``."""
    rp, rj = _fill(port_observe), _fill(jax_observe)
    text = rp.to_prometheus()
    assert text == rj.to_prometheus()
    assert "# HELP serving_retries_total fault-path requeues" in text
    assert 'serving_ttft_ticks_bucket{le="+Inf"} 2' in text
    assert 'serving_tenant_itl_ticks_bucket{tenant="a",le="4.0"} 1' in text
    assert rp.as_dict() == rj.as_dict()
    assert rp.quantiles("serving_ttft_ticks") \
        == rj.quantiles("serving_ttft_ticks")


def test_flight_recorder_ring_is_bounded():
    """The ring keeps the last ``capacity`` events; the tracer's event
    log keeps all of them; ``flight`` filters by request and ``attach``
    ships the ring in an error's payload."""
    rec = port_observe.FlightRecorder(capacity=8)
    trc = port_observe.Tracer(recorder=rec)
    for i in range(50):
        trc.set_tick(i)
        trc.instant("submitted", request_id=i)
    assert len(rec) == 8
    assert [e.request_id for e in rec.events()] == list(range(42, 50))
    assert len(trc.events) == 50
    assert [e["args"]["request_id"] for e in trc.flight(45)] == [45]
    err = trc.attach(port_health.PoolExhausted("full"))
    assert err.payload["flight"] == trc.flight()
    json.dumps(err.payload["flight"])
    rec.clear()
    assert len(rec) == 0
    capped = port_observe.Tracer(max_events=3)
    for i in range(5):
        capped.instant("submitted", request_id=i)
    assert (len(capped.events), capped.dropped, len(capped.recorder)) \
        == (3, 2, 5)


def test_trace_event_matches_jax():
    """A span and an instant: the same ``tick_key`` and chrome dict as
    the JAX ``TraceEvent``."""
    for args in ((), (("bucket", 16), ("slot", 2))):
        ep = port_observe.TraceEvent("prefill", "X", 7, 1.5, 0.25, 3, 2,
                                     args)
        ej = jax_observe.TraceEvent("prefill", "X", 7, 1.5, 0.25, 3, 2,
                                    args)
        assert ep.tick_key() == ej.tick_key()
        assert ep.to_chrome() == ej.to_chrome()
        ip = port_observe.TraceEvent("submitted", "i", 7, 1.5)
        ij = jax_observe.TraceEvent("submitted", "i", 7, 1.5)
        assert ip.to_chrome() == ij.to_chrome()


def test_servingstats_is_a_registry_view():
    """The counter block and the registry share storage: a write
    through either face shows through the other; ``as_dict`` and
    ``snapshot`` are the JAX ones on the same counts; unknown fields
    raise."""
    stats = port_serving.ServingStats()
    stats.preemptions += 2
    assert stats.registry.counter("serving_preemptions_total").value == 2
    stats.registry.counter("serving_preemptions_total").inc(1)
    assert stats.preemptions == 3
    stats.tokens_drafted = 10
    stats.tokens_accepted = 4
    want = jax_serving.ServingStats(preemptions=3, tokens_drafted=10,
                                    tokens_accepted=4)
    assert stats.as_dict() == want.as_dict()
    assert port_health.snapshot(stats) == want.as_dict()
    assert stats.acceptance_rate == pytest.approx(0.4)
    assert stats == port_serving.ServingStats(
        preemptions=3, tokens_drafted=10, tokens_accepted=4)
    assert port_health.STAT_FIELDS == jax_serving.health.STAT_FIELDS
    assert stats.registry.to_prometheus() == want.registry.to_prometheus()
    assert repr(port_serving.ServingStats()) \
        == repr(jax_serving.ServingStats())
    with pytest.raises(TypeError):
        port_serving.ServingStats(not_a_counter=1)
    with pytest.raises(AttributeError):
        stats.not_a_counter = 1
    outcome = port_serving.RequestOutcome((1, 2), "length", ttft_ticks=3)
    assert port_health.snapshot(outcome)["ttft_ticks"] == 3


# -- scheduler integration ----------------------------------------------------

_PROMPTS = ((7, 11, 13), (7, 11, 14), (7, 11, 15, 17, 19, 23, 29, 31, 37,
                                       41))
_CHUNKY = tuple((7, 11, 13 + s, 17, 19, 23, 29 + s, 31, 37, 41)
                for s in range(3))
# repetitive prompts, so the n-gram drafter proposes
_MOTIF = ((7, 11, 7, 11, 7, 11, 7, 11), (5, 3, 5, 3, 5, 3), (7, 11, 13))


def _reqs(cls, prompts, max_new=6):
    return [cls(prompt=p, max_new_tokens=max_new,
                temperature=0.7 if s % 2 else 0.0, seed=s)
            for s, p in enumerate(prompts)]


def _port_run(model, tracer=None, spec_k=0, chunk=None, num_pages=20,
              prompts=_PROMPTS, dense=False, **kw):
    _, _, cfg, params = model
    if dense:
        eng = port_serving.DecodeEngine(
            params, cfg, num_slots=2, max_len=MAX_LEN,
            cache_dtype=torch.float32, tracer=tracer, device="cpu")
    else:
        eng = port_serving.PagedDecodeEngine(
            params, cfg, num_slots=2, max_len=MAX_LEN, num_pages=num_pages,
            page_size=4, buckets=(16, 32), spec_k=spec_k,
            cache_dtype=torch.float32, tracer=tracer, device="cpu", **kw)
    sched = port_serving.ContinuousBatchingScheduler(eng, eos_id=EOS,
                                                     chunk_tokens=chunk)
    for r in _reqs(port_serving.Request, prompts):
        sched.submit(r)
    with torch.inference_mode():
        while sched.busy:
            sched.step()
            eng.check_invariants()
    return sched, sched.run()


def _jax_run(model, tracer, spec_k=0, chunk=None, num_pages=20,
             prompts=_PROMPTS, dense=False, **kw):
    cfg, params, _, _ = model
    if dense:
        eng = jax_serving.DecodeEngine(params, cfg, num_slots=2,
                                       max_len=MAX_LEN,
                                       cache_dtype=jnp.float32,
                                       tracer=tracer)
    else:
        eng = jax_serving.PagedDecodeEngine(
            params, cfg, num_slots=2, max_len=MAX_LEN, num_pages=num_pages,
            page_size=4, buckets=(16, 32), spec_k=spec_k,
            cache_dtype=jnp.float32, tracer=tracer, **kw)
    sched = jax_serving.ContinuousBatchingScheduler(
        eng, eos_id=EOS, audit=not dense, chunk_tokens=chunk)
    for r in _reqs(jax_serving.Request, prompts):
        sched.submit(r)
    return sched, sched.run()


def _ticks(sched):
    return [(o.tokens, o.reason, o.ttft_ticks, o.total_ticks,
             o.prefill_ticks) for _, o in sorted(sched.outcomes.items())]


_CASES = {
    "plain": {},
    "spec": dict(spec_k=2, prompts=_MOTIF),
    "chunked": dict(chunk=4, prompts=_CHUNKY),
}


@pytest.fixture(scope="module")
def traced(model):
    """A case's traced port and JAX runs, run once for the module:
    ``(port tracer, JAX tracer, (port scheduler, streams), (JAX
    scheduler, streams))``."""
    runs = {}

    def get(case):
        if case not in runs:
            kw = _CASES[case]
            tp, tj = port_observe.Tracer(), jax_serving.Tracer()
            runs[case] = (tp, tj, _port_run(model, tp, **kw),
                          _jax_run(model, tj, **kw))
        return runs[case]

    return get


@pytest.mark.parametrize("case", sorted(_CASES))
def test_tick_stream_equals_jax(traced, case):
    """Traced runs with no fault injector: the port's tick-clock event
    stream is the JAX scheduler's event for event (names, kinds, ticks,
    request ids, slots, args), and so are the committed streams, the
    outcomes' tick fields, the latency summary and the whole registry
    (counters, gauges, histograms) as Prometheus text."""
    kw = _CASES[case]
    tp, tj, (sp, outp), (sj, outj) = traced(case)
    assert outp == outj
    assert tp.tick_stream() == tj.tick_stream()
    assert len(tp.tick_stream()) > 0
    assert _ticks(sp) == _ticks(sj)
    assert tp.latency_summary() == tj.latency_summary()
    assert tp.registry.to_prometheus() == tj.registry.to_prometheus()
    assert sp.stats.as_dict() == sj.stats.as_dict()
    names = {e.name for e in tp.events}
    assert names <= set(port_observe.PHASES) | set(port_observe.LIFECYCLE)
    if kw.get("chunk"):
        assert "chunk_prefill" in names and sp.stats.prefill_chunks > 3
    if kw.get("spec_k"):
        assert sp.stats.spec_ticks > 0
        assert tp.registry.get("serving_stream_acceptance_rate",
                               labels={"slot": 0}) is not None


def test_host_tier_tick_stream_equals_jax(model):
    """A pool small enough to spill: the host_spill and host_promote
    instants, the tier gauges and the rest of the stream are the JAX
    run's."""
    hot = tuple(range(7, 15))
    cold = tuple(tuple(range(100 * k + 1, 100 * k + 9)) for k in (1, 2, 3))
    prompts = (hot,) + cold + (hot,)
    tp, tj = port_observe.Tracer(), jax_serving.Tracer()
    sp, outp = _port_run(model, tp, num_pages=10, prompts=prompts,
                         host_tier=port_serving.PrefixRegistry(1 << 20))
    sj, outj = _jax_run(model, tj, num_pages=10, prompts=prompts,
                        host_tier=jax_serving.PrefixRegistry(1 << 20))
    assert outp == outj
    assert sp.stats.host_spills > 0 and sp.stats.host_promotes > 0
    assert {"host_spill", "host_promote"} <= {e.name for e in tp.events}
    assert tp.tick_stream() == tj.tick_stream()
    assert tp.registry.to_prometheus() == tj.registry.to_prometheus()
    assert tp.registry.get("serving_page_pool_host_pages") is not None


def test_inert_tracer_and_tracing_never_perturbs_streams(model):
    """An engine built without a tracer gets a disabled one: no events,
    but the stats live on its registry; traced runs (plain, speculative,
    chunked) commit the untraced streams."""
    sched, bare = _port_run(model)
    trc = sched.engine.tracer
    assert trc.enabled is False
    assert trc.events == [] and len(trc.recorder) == 0
    assert sched.stats is sched.engine.stats
    assert sched.stats.registry is trc.registry
    assert trc.registry.counter("serving_plain_ticks_total").value \
        == sched.stats.plain_ticks > 0
    assert trc.registry.get("serving_ttft_ticks") is None
    assert all(o.ttft_ticks is not None for o in sched.outcomes.values())
    assert _port_run(model, port_observe.Tracer())[1] == bare
    assert _port_run(model, port_observe.Tracer(), spec_k=2)[1] == bare
    chunked = _port_run(model, chunk=4, prompts=_CHUNKY)[1]
    assert _port_run(model, port_observe.Tracer(), chunk=4,
                     prompts=_CHUNKY)[1] == chunked
    dense = port_serving.DecodeEngine(model[3], model[2], num_slots=1,
                                      max_len=MAX_LEN, device="cpu")
    assert dense.tracer.enabled is False
    assert dense.stats.registry is dense.tracer.registry


def test_pool_gauges_track_the_pool(model):
    """The end-of-tick pool gauges read the pool after the last tick; a
    tier-less engine creates no host-tier gauges."""
    trc = port_observe.Tracer()
    sched, _ = _port_run(model, trc)
    eng, reg = sched.engine, trc.registry
    assert reg.get("serving_pages_free").value == eng.pool.num_free
    assert reg.get("serving_pages_cached").value == eng.pool.num_cached
    assert reg.get("serving_page_pool_occupancy").value \
        == pytest.approx(eng.pool.occupancy)
    assert reg.get("serving_page_pool_host_pages") is None


def test_perfetto_jsonl_dump_matches_jax(traced, tmp_path):
    """The dump is one JSON object a line with ``ph``/``ts``/``name``,
    spans and instants both present, and equals the JAX dump of the
    same (speculative) run once the wall-clock fields (``wall_s``,
    ``dur``) are dropped."""
    tp, tj = traced("spec")[:2]

    def load(trc, name):
        path = tmp_path / name
        n = trc.dump_jsonl(str(path))
        lines = [json.loads(ln) for ln in path.read_text().splitlines()]
        assert n == len(lines) == len(trc.events) > 0
        for d in lines:
            assert {"ph", "ts", "name"} <= set(d)
            assert d["ts"] == d["args"]["tick"] * 1000
            assert d["args"].pop("wall_s") >= 0
            if d["ph"] == "X":
                assert d.pop("dur") >= 1
        return lines

    got = load(tp, "port.jsonl")
    assert {d["ph"] for d in got} == {"X", "i"}
    assert got == load(tj, "jax.jsonl")


# -- the cross-replica tier ---------------------------------------------------

def _routed(model, mod, pool):
    """The reference's traced routed run on either package: the pair
    under one pinned ``page_send`` drop, or the 2x2 pool under a pinned
    reshard drop and decode0's death; three sampled requests."""
    jcfg, jp, pcfg, pp = model
    if pool:
        inj = mod.FaultInjector(schedule={"reshard_send": (0,),
                                          "replica_health": (2, 6)})
    else:
        inj = mod.FaultInjector(schedule={"page_send": (0,)})
    trc = mod.Tracer()
    cfg, params = (pcfg, pp) if mod is port_serving else (jcfg, jp)
    dev = {"device": "cpu"} if mod is port_serving else {}
    engines = [mod.PagedDecodeEngine(
        params, cfg, num_slots=2, max_len=MAX_LEN, num_pages=20,
        page_size=4, buckets=(16, 32), injector=inj, tracer=trc, **dev)
        for _ in range(4 if pool else 2)]
    if pool:
        router = mod.PoolRouter(engines[:2], engines[2:], EOS, audit=True)
    else:
        router = mod.DisaggregatedRouter(*engines, EOS, audit=True)
    for s in range(3):
        router.submit(mod.Request(prompt=(7, 11, 13 + s), max_new_tokens=6,
                                  temperature=0.7, seed=s))
    with torch.inference_mode():
        router.run()
    return router, trc


def _same_as_jax(model, pool):
    router, trc = _routed(model, port_serving, pool)
    jrouter, jtrc = _routed(model, jax_serving, pool)
    assert trc.tick_stream() == jtrc.tick_stream()
    assert trc.registry.to_prometheus() == jtrc.registry.to_prometheus()
    assert router.stats.as_dict() == jrouter.stats.as_dict()
    again = _routed(model, port_serving, pool)[1]
    assert trc.tick_stream() == again.tick_stream()
    return router, trc


def test_disagg_transfer_metrics_and_replay(model):
    """The pair's observability: one ``page_transfer`` span a handoff
    (the pinned drop retried inside the first), per-replica labeled
    transfer counters, the ``serving_transfer_ticks`` histogram, both
    health gauges, one counter block; the tick stream replays and
    equals the JAX package's, and so does the registry."""
    router, trc = _same_as_jax(model, pool=False)
    names = {e.name for e in trc.events}
    assert "page_transfer" in names
    assert names <= set(port_observe.PHASES) | set(port_observe.LIFECYCLE)
    spans = [e for e in trc.events if e.name == "page_transfer"]
    assert len(spans) == router.stats.remote_prefills == 3
    assert router.stats.transfer_retries == 1
    assert router.stats.transfer_failures == 0
    reg = trc.registry
    labels = {"replica": "prefill"}
    assert reg.get("serving_transfer_src_bytes_total",
                   labels=labels).value > 0
    assert reg.get("serving_transfer_src_retries_total",
                   labels=labels).value == 1
    assert reg.get("serving_transfer_src_failures_total",
                   labels=labels).value == 0
    assert reg.get("serving_transfer_ticks", labels=labels).count == 3
    for replica in ("prefill", "decode"):
        assert reg.get("serving_replica_health",
                       labels={"replica": replica}).value \
            == port_serving.HEALTH_STATES.index("healthy")
    assert router.stats.registry is reg
    assert reg.counter("serving_transfers_total").value \
        == router.stats.transfers == 3


def test_pool_metrics_and_replay(model):
    """The pool's observability: one ``reshard`` span a device-to-device
    handoff, the routing counters by reason, the per-replica load gauge,
    labeled reshard counters, the ``rebalance`` instant of the failover
    move; the tick stream replays and equals the JAX package's, and so
    does the registry."""
    pool, trc = _same_as_jax(model, pool=True)
    names = {e.name for e in trc.events}
    assert {"reshard", "rebalance"} <= names
    assert names <= set(port_observe.PHASES) | set(port_observe.LIFECYCLE)
    spans = [e for e in trc.events if e.name == "reshard"]
    assert len(spans) == pool.stats.reshards >= 3
    assert pool.stats.reshard_retries == 1
    assert pool.stats.reshard_failures == 0
    assert pool.stats.failovers == 1 and pool.stats.rebalances == 1
    reg = trc.registry
    assert reg.get("serving_pool_routing_total",
                   labels={"reason": "load"}).value \
        == pool.stats.remote_prefills
    for replica in ("prefill0", "prefill1"):
        assert reg.get("serving_pool_replica_load",
                       labels={"replica": replica}) is not None
    total = sum(
        reg.get("serving_reshard_src_bytes_total", labels={"replica": r})
        .value for r in ("prefill0", "prefill1")
        if reg.get("serving_reshard_src_bytes_total",
                   labels={"replica": r}) is not None)
    assert total > 0
    for replica in ("prefill0", "prefill1", "decode0", "decode1"):
        g = reg.get("serving_replica_health", labels={"replica": replica})
        assert g is not None \
            and g.value <= port_serving.HEALTH_STATES.index("healthy")

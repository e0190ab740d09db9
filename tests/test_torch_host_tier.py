"""Port parity for the host spill tier (the fault-free cases of
``tests/L0/run_serving/test_hierarchy.py``): ``apex_tpu_torch``'s
``PagedDecodeEngine(host_tier=...)`` on ``gpt_tiny`` with RoPE, page
size 4, a pool small enough that churn evicts the hot prefix. The port
runs on the CPU; the JAX side as its own serving tests run it, the
params carried across by ``params_from_jax``.

- evicted prefix pages the registry alone holds spill to the
  ``PrefixRegistry``; a later admission promotes them back, the promoted
  pages bit for bit the spilled ones (an int8 pool's scale planes too);
- pages a slot still attends never spill; the registry's byte budget,
  LRU and oversized rejection; corrupt and stale records are dropped
  with ``PromoteFailed`` counted, and the admission re-prefills;
- committed streams equal a spill-disabled engine's (greedy, sampled,
  speculative; fp32 and int8 pools) and the JAX engine's with the same
  tier, with its spill and promote counters and its outcomes' tick
  accounting: a promoted admission is charged its suffix's depth plus
  the promote ticks, so the re-admitted prompt's TTFT beats the
  re-prefill's;
- through a ``DisaggregatedRouter`` whose replicas share one registry,
  the routed streams equal the tier-less pair's, and the JAX pair's
  stats, tick stream and ticks; a registry on one replica only is
  refused.

The fault-site cases (``host_spill`` / ``host_promote`` injection) wait
for the fault injector (ROADMAP A4.4)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import serving as jax_serving
from apex_tpu.models import gpt as jax_gpt
from apex_tpu_torch import serving as port_serving
from apex_tpu_torch.models import gpt as port_gpt
from apex_tpu_torch.serving import (
    PoolInvariantError, PrefixRegistry, PromoteFailed, SpillRecord,
    prefix_page_keys,
)

EOS = -1
MAX_LEN = 32
HOT = tuple(range(7, 15))
COLD = ((101, 102, 103, 104, 105, 106, 107, 108),
        (201, 202, 203, 204, 205, 206, 207, 208),
        (301, 302, 303, 304, 305, 306, 307, 308))


@pytest.fixture(scope="module")
def model():
    jcfg = dataclasses.replace(jax_gpt.gpt_tiny(), use_rope=True,
                               hidden_dropout=0.0)
    pcfg = dataclasses.replace(port_gpt.gpt_tiny(), use_rope=True,
                               hidden_dropout=0.0)
    jp = jax_gpt.init_gpt(jax.random.PRNGKey(0), jcfg)
    pp = port_gpt.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, jp, pcfg, pp


def _engine(model, host_tier=None, num_pages=10,
            cache_dtype=torch.float32, **kw):
    _, _, cfg, params = model
    return port_serving.PagedDecodeEngine(
        params, cfg, num_slots=2, max_len=MAX_LEN, num_pages=num_pages,
        page_size=4, buckets=(16, 32), host_tier=host_tier,
        cache_dtype=cache_dtype, device="cpu", **kw)


def _jax_engine(model, host_tier=None, cache_dtype=jnp.float32, **kw):
    cfg, params, _, _ = model
    return jax_serving.PagedDecodeEngine(
        params, cfg, num_slots=2, max_len=MAX_LEN, num_pages=10,
        page_size=4, buckets=(16, 32), host_tier=host_tier,
        cache_dtype=cache_dtype, **kw)


def _churn_reqs(req):
    """Admit HOT, churn it out through three cold prompts (the 8-page
    pool spills it), re-admit HOT — once greedy, once sampled."""
    return ([req(prompt=HOT, max_new_tokens=4)]
            + [req(prompt=p, max_new_tokens=4) for p in COLD]
            + [req(prompt=HOT, max_new_tokens=4, temperature=1.0,
                   seed=3)])


def _drive(engine):
    sched = port_serving.ContinuousBatchingScheduler(engine, eos_id=EOS)
    for r in _churn_reqs(port_serving.Request):
        sched.submit(r)
    with torch.inference_mode():
        while sched.busy:
            sched.step()
            assert engine.check_invariants()
    return sched, sched.run()


def _jax_drive(engine):
    sched = jax_serving.ContinuousBatchingScheduler(engine, eos_id=EOS,
                                                    audit=True)
    for r in _churn_reqs(jax_serving.Request):
        sched.submit(r)
    return sched, sched.run()


@pytest.fixture(scope="module")
def golden_run(model):
    """One tier-less churn drive, shared by the tests that need only its
    streams and ticks."""
    return _drive(_engine(model))


def _snap(eng, pages):
    return [t.clone() for t in eng._tier_extract(eng.cache, pages)]


def _drain(eng):
    held = []
    while (p := eng.pool.alloc()) is not None:
        held.append(p)
    return held


# -- spill / promote mechanics ----------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_spill_on_evict_then_promote_bitwise_equal(model, dtype):
    """Pool churn spills the hot prefix; re-admission promotes it and
    the promoted pages carry the spilled bytes bit for bit (an int8
    pool's scale planes with its tiles; a bf16 pool's rows cross the
    host as their 16-bit patterns)."""
    tier = PrefixRegistry(1 << 20)
    eng = _engine(model, host_tier=tier,
                  cache_dtype=getattr(torch, dtype))
    with torch.inference_mode():
        eng.prefill(0, HOT)
    keys = prefix_page_keys(list(HOT), eng.page_size)
    snap = _snap(eng, list(eng._slot_pages[0]))
    assert len(snap) == (4 if dtype == "int8" else 2)
    eng.free_slot(0)
    held = _drain(eng)
    assert eng.stats.host_spills == len(keys) == 2
    assert eng.stats.host_spill_bytes == sum(tier.get(k).nbytes for k in keys)
    rec = tier.get(keys[0])
    assert (rec.k_scale is not None) == (dtype == "int8")
    tier.check_invariants()
    for p in held:
        eng.pool.release(p)
    hits = tier.hits
    promoted, ticks = eng._promote_chain(keys, 0)
    assert len(promoted) == 2 and ticks == 1 and tier.hits == hits + 2
    assert (eng.stats.host_promotes, eng.stats.host_promote_ticks) == (2, 1)
    assert eng.stats.host_promote_bytes == eng.stats.host_spill_bytes
    for a, b in zip(snap, _snap(eng, promoted)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    for p in promoted:
        eng.pool.release(p)
    assert tier.hit_rate > 0
    gauges = eng.pool_gauges()
    assert gauges["host_pages"] == 2 and gauges["host_bytes"] > 0


def test_spill_record_matches_jax(model):
    """The port's spill record of the hot prefix's first page is the JAX
    engine's: the same header, digest and payload bytes within the two
    frameworks' projections (the header and geometry exactly)."""
    tier, jtier = PrefixRegistry(1 << 20), jax_serving.PrefixRegistry(
        1 << 20)
    eng, jeng = _engine(model, host_tier=tier), _jax_engine(
        model, host_tier=jtier)
    with torch.inference_mode():
        eng.prefill(0, HOT)
    jeng.prefill(0, HOT)
    for e in (eng, jeng):
        e.free_slot(0)
        while e.pool.alloc() is not None:
            pass
    key = prefix_page_keys(list(HOT), 4)[0]
    rec, jrec = tier.get(key), jtier.get(key)
    assert rec.header == jrec.header and rec.nbytes == jrec.nbytes
    np.testing.assert_allclose(rec.k, np.asarray(jrec.k), rtol=1e-5,
                               atol=1e-5)
    assert eng._spill_geometry == jeng._spill_geometry


def test_attended_pages_never_spill(model):
    """A page a slot still attends (refcount > 1) leaves the registry
    on the sweep without spilling."""
    tier = PrefixRegistry(1 << 20)
    eng = _engine(model, host_tier=tier)
    with torch.inference_mode():
        eng.prefill(0, HOT)
    keys = prefix_page_keys(list(HOT), eng.page_size)
    assert all(eng.pool.refcount(p) == 2 for p in eng._slot_pages[0])
    held = _drain(eng)
    assert eng.stats.host_spills == 0 and len(tier) == 0
    assert all(k not in tier for k in keys)
    assert all(eng.pool.refcount(p) == 1 for p in eng._slot_pages[0])
    for p in held:
        eng.pool.release(p)
    eng.free_slot(0)
    eng.pool.check_invariants()


def _spilled(model):
    tier = PrefixRegistry(1 << 20)
    eng = _engine(model, host_tier=tier)
    with torch.inference_mode():
        eng.prefill(0, HOT)
    eng.free_slot(0)
    _drain(eng)
    return tier, eng


def test_registry_budget_lru_and_oversized_rejection(model):
    """Byte-budgeted LRU: admission evicts the coldest records to fit; a
    record over the whole budget is rejected; a re-put only refreshes."""
    tier, _ = _spilled(model)
    rec = next(iter(tier._entries.values()))
    small = PrefixRegistry(rec.nbytes)
    keys = list(tier._entries)
    assert small.put(keys[0], tier._entries[keys[0]])
    assert small.put(keys[1], tier._entries[keys[1]])
    assert len(small) == 1 and small.evictions == 1
    assert keys[0] not in small and keys[1] in small
    small.check_invariants()
    tiny = PrefixRegistry(rec.nbytes - 1)
    assert not tiny.put(keys[0], tier._entries[keys[0]])
    assert tiny.rejected == 1 and len(tiny) == 0
    assert not small.put(keys[1], tier._entries[keys[1]])


def test_registry_invariants_catch_corruption(model):
    tier, _ = _spilled(model)
    tier.check_invariants()
    key = next(iter(tier._entries))
    rec = tier._entries[key]
    tier._entries[key] = rec._replace(k=np.ascontiguousarray(rec.k) + 1)
    with pytest.raises(PoolInvariantError,
                       match="fails its spill checksum"):
        tier.check_invariants()
    tier._entries[key] = rec
    tier._bytes += 1
    with pytest.raises(PoolInvariantError, match="drifted"):
        tier.check_invariants()
    tier._bytes -= 1
    with pytest.raises(ValueError, match="different chain key"):
        tier.put(b"\x00" * 32, rec)


def test_corrupt_record_quarantined_promote_degrades(model, golden_run):
    """A record whose payload rotted fails its checksum at promotion: it
    is dropped (never installed), ``host_promote_failures`` counts it,
    ``_verify_spill`` raises ``PromoteFailed`` naming the key, and a
    full run over the same shape stays golden."""
    _, golden = golden_run
    tier, eng = _spilled(model)
    keys = prefix_page_keys(list(HOT), eng.page_size)
    rec = tier._entries[keys[0]]
    flipped = np.ascontiguousarray(rec.k).copy()
    flipped.flat[0] = -flipped.flat[0] if flipped.flat[0] else 1
    bad = SpillRecord(rec.header, flipped, rec.v, rec.k_scale,
                      rec.v_scale, rec.digest)
    with pytest.raises(PromoteFailed, match="checksum mismatch") as e:
        eng._verify_spill(keys[0], bad)
    assert e.value.key == keys[0].hex()
    tier._entries[keys[0]] = bad
    promoted, ticks = eng._promote_chain(keys, 0)
    assert promoted == [] and ticks == 0
    assert eng.stats.host_promote_failures == 1
    assert keys[0] not in tier
    _, outs = _drive(_engine(model, host_tier=PrefixRegistry(1 << 20)))
    assert outs == golden


def test_stale_header_key_is_rejected(model):
    """A record registered under one chain key never installs under
    another; a record of another pool geometry is refused too."""
    tier, eng = _spilled(model)
    keys = prefix_page_keys(list(HOT), eng.page_size)
    other = prefix_page_keys([9, 9, 9, 9], eng.page_size)
    rec = tier._entries[keys[0]]
    tier._entries[other[0]] = rec
    tier._bytes += rec.nbytes
    promoted, _ = eng._promote_chain(other, 0)
    assert promoted == [] and eng.stats.host_promote_failures == 1
    assert other[0] not in tier
    geom = eng._spill_geometry
    eng._spill_geometry = geom[:2] + (8,) + geom[3:]
    with pytest.raises(PromoteFailed, match="geometry"):
        eng._verify_spill(keys[0], rec)


# -- streams -----------------------------------------------------------------

STREAM_CASES = {  # name -> (pool dtype, engine kwargs)
    "f32": ("float32", {}),
    "f32_spec": ("float32", {"spec_k": 2}),
    "int8": ("int8", {}),
}


@pytest.mark.parametrize("case", sorted(STREAM_CASES))
def test_streams_bit_identical_to_spill_disabled_and_jax(model, case):
    """The tier is invisible to committed streams: greedy and sampled
    tokens match a spill-disabled engine's and the JAX engine's with the
    same tier, with its spill/promote counters and tick accounting,
    while the spill and promote paths demonstrably ran."""
    dtype, kw = STREAM_CASES[case]
    _, golden = _drive(_engine(model, cache_dtype=getattr(torch, dtype),
                               **kw))
    tier = PrefixRegistry(1 << 20)
    eng = _engine(model, host_tier=tier, cache_dtype=getattr(torch, dtype),
                  **kw)
    sched, outs = _drive(eng)
    assert outs == golden
    assert eng.stats.host_spills > 0 and eng.stats.host_promotes > 0
    assert eng.stats.host_promote_ticks >= 1 and tier.hit_rate > 0
    jtier = jax_serving.PrefixRegistry(1 << 20)
    jeng = _jax_engine(model, host_tier=jtier,
                       cache_dtype=getattr(jnp, dtype), **kw)
    jsched, want = _jax_drive(jeng)
    assert outs == want
    st = jeng.stats
    ps = eng.stats
    assert (ps.host_spills, ps.host_spill_bytes, ps.host_promotes,
            ps.host_promote_bytes, ps.host_promote_ticks,
            ps.host_promote_failures) == (
        st.host_spills, st.host_spill_bytes, st.host_promotes,
        st.host_promote_bytes, st.host_promote_ticks,
        st.host_promote_failures)
    for rid in range(len(outs)):
        o, w = sched.outcomes[rid], jsched.outcomes[rid]
        assert (o.ttft_ticks, o.total_ticks) == (w.ttft_ticks,
                                                 w.total_ticks)
    assert tier.stats() == jtier.stats()


def test_promote_reprices_the_admission_clock(model, golden_run):
    """A host-tier hit admits at the suffix's depth plus the promote
    ticks: the re-admitted hot prompt's TTFT beats the spill-disabled
    engine's re-prefill on the tick clock."""
    sched_b, golden = golden_run
    sched_a, outs = _drive(_engine(model,
                                   host_tier=PrefixRegistry(1 << 20)))
    assert outs == golden
    rid = len(COLD) + 1
    ttft_a = sched_a.outcomes[rid].ttft_ticks
    ttft_b = sched_b.outcomes[rid].ttft_ticks
    assert ttft_a < ttft_b, (ttft_a, ttft_b)


def test_host_tier_takes_known_dtypes_only(model):
    _, _, cfg, params = model
    with pytest.raises(ValueError, match="spill wire tag"):
        port_serving.PagedDecodeEngine(
            params, cfg, num_slots=1, max_len=MAX_LEN, num_pages=10,
            page_size=4, buckets=(16, 32), cache_dtype=torch.float64,
            host_tier=PrefixRegistry(1 << 20), device="cpu")


# -- the disaggregated pair over one registry ---------------------------------

def _disagg(model, tier, mod=port_serving):
    """The churn drive through a ``DisaggregatedRouter`` whose replicas
    (fp32 pools of 10 pages) share ``tier``, traced."""
    jcfg, jp, pcfg, pp = model
    inj, trc = mod.FaultInjector(), mod.Tracer()
    if mod is port_serving:
        pe, de = (_engine(model, host_tier=tier, injector=inj, tracer=trc)
                  for _ in range(2))
    else:
        pe, de = (_jax_engine(model, host_tier=tier, injector=inj,
                              tracer=trc) for _ in range(2))
    router = mod.DisaggregatedRouter(pe, de, eos_id=EOS, audit=True)
    for r in _churn_reqs(mod.Request):
        router.submit(r)
    with torch.inference_mode():
        outs = router.run()
    return pe, de, router, outs


def test_disagg_pair_shares_one_registry(model):
    """Both replicas spill into and promote from ONE registry (the
    active side promotes the remote's spills), the routed streams equal
    the tier-less pair's, and the JAX pair's streams, stats, tick
    stream and outcomes' ticks with the same tier."""
    golden = _disagg(model, None)[3]
    tier = PrefixRegistry(1 << 20)
    pe, de, router, outs = _disagg(model, tier)
    assert outs == golden
    assert de.stats.host_promotes > 0
    assert pe.stats.host_spills + de.stats.host_spills > 0
    assert tier.hit_rate > 0
    jtier = jax_serving.PrefixRegistry(1 << 20)
    _, _, jrouter, jouts = _disagg(model, jtier, jax_serving)
    assert outs == jouts
    assert router.stats.as_dict() == jrouter.stats.as_dict()
    assert router.tracer.tick_stream() == jrouter.tracer.tick_stream()
    assert [(o.ttft_ticks, o.total_ticks) for _, o in
            sorted(router.outcomes.items())] == [
        (o.ttft_ticks, o.total_ticks) for _, o in
        sorted(jrouter.outcomes.items())]
    assert tier.stats() == jtier.stats()


def test_disagg_rejects_mismatched_tiers(model):
    """A tier on one replica only is refused, with the JAX message."""
    def refuse(mod, make):
        inj, trc = mod.FaultInjector(), mod.Tracer()
        pe = make(model, host_tier=mod.PrefixRegistry(1024), injector=inj,
                  tracer=trc)
        de = make(model, host_tier=None, injector=inj, tracer=trc)
        with pytest.raises(ValueError, match="share ONE PrefixRegistry") \
                as ei:
            mod.DisaggregatedRouter(pe, de, eos_id=EOS)
        return str(ei.value)

    assert refuse(port_serving, _engine) == refuse(jax_serving, _jax_engine)

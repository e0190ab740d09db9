"""Port parity for the disaggregated serving tier (``apex_tpu_torch.
serving.router``'s ``DisaggregatedRouter`` and ``serving.transfer``'s
``PageTransfer``) against the JAX package on the CPU.

Every case of ``tests/L0/run_serving/test_router.py`` runs on the port
(``gpt_tiny`` with RoPE, the params carried across by
``params_from_jax``; two replicas of 2 slots, max_len 32, pages of 4,
buckets (16, 32), one shared injector and live ``Tracer``, audited every
tick) and is held to the reference's contract against the port's own
colocated golden: fault-free routed streams equal the colocated
scheduler's, every transfer or replica fault ends typed with the golden
stream, a corrupt payload is quarantined, failover resumes bit for bit.
Then the same schedule runs on the JAX package (once a module) and the
streams, each outcome's reason, retries, error class and tick fields,
``ServingStats``, ``injector.counts``, the registry's Prometheus text
(the per-replica transfer counters, the ``serving_transfer_ticks``
histogram, the health gauges), the replicas' health ladders and
``tracer.tick_stream()`` are equal. ``transfer_checksum`` gives the
JAX package's digest for the same bf16 and fp32 tiles. On the card's
geometry a one-layer model reads the open-loop tick clock that
``chip_smoke.py``'s ``serving_disagg`` must print.

``eos_id=-1`` throughout: golden streams run to ``max_new_tokens``. The
port runs on one CPU thread, and the JAX engines share their jitted step
functions (the module's fixtures).
"""

import dataclasses
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import serving as jax_serving
from apex_tpu.models import gpt as jax_gpt
from apex_tpu.serving import transfer as jax_transfer
from apex_tpu_torch import serving as S
from apex_tpu_torch.models import gpt as port_gpt
from apex_tpu_torch.serving import transfer as port_transfer

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


def _router(model, mod, schedule=None, rates=None, seed=0, spec_k=0,
            reqs=_REQS):
    """The reference's chaos pair on ``mod``, driven to the end."""
    inj = mod.FaultInjector(seed=seed, rates=rates, schedule=schedule)
    trc = mod.Tracer()
    router = mod.DisaggregatedRouter(
        _engine(model, mod, inj, trc, spec_k=spec_k),
        _engine(model, mod, inj, trc, spec_k=spec_k), EOS, audit=True)
    _drive(router, mod, reqs)
    return router


_RATES = {"page_send": 0.25, "page_recv": 0.2, "replica_health": 0.12,
          "decode_exec": 0.05}
_SCENARIOS = {
    "fault_free": {},
    "fault_free_spec2": dict(spec_k=2),
    "dedup": dict(reqs=_DEDUP),
    "send_fault": dict(schedule={"page_send": (0,)}),
    "recv_corrupt": dict(schedule={"page_recv": (0,)}),
    "health_probe": dict(schedule={"replica_health": (0,)}),
    "budget_exhausted": dict(schedule={"page_send": (0, 1, 2)}),
    "remote_down": dict(schedule={"replica_health": tuple(range(0, 40, 2))}),
    "active_down": dict(schedule={"replica_health": (1, 3)}),
    "both_down": dict(schedule={"replica_health": tuple(range(2, 32, 2))
                                + (5, 7)}, reqs=_REQS[:2]),
    **{f"chaos_seed{s}": dict(rates=_RATES, seed=s) for s in SEEDS},
}


def _summary(router):
    """What a routed run must replay, and equal on both packages."""
    return dict(
        outcomes={rid: (tuple(o.tokens), o.reason, o.retries,
                        type(o.error).__name__, o.ttft_ticks,
                        o.total_ticks, o.prefill_ticks)
                  for rid, o in sorted(router.outcomes.items())},
        stats=router.stats.as_dict(),
        counts=router.engine.injector.counts,
        ticks=router.tracer.tick_stream(),
        metrics=router.tracer.registry.to_prometheus(),
        health={n: (h.state, h.transitions)
                for n, h in sorted(router.health.items())},
        active=router.engine.active_name)


def _run(model, jax_runs, name):
    """The scenario on the port; its JAX run (made once a module) must
    give the same summary. Returns the port's router."""
    router = _router(model, S, **_SCENARIOS[name])
    if name not in jax_runs:
        jax_runs[name] = _summary(_router(model, jax_serving,
                                          **_SCENARIOS[name]))
    got, want = _summary(router), jax_runs[name]
    for key in want:
        assert got[key] == want[key], f"{name}: {key} differs from JAX"
    return router


def _assert_all_ok_golden(router, golden):
    assert sorted(router.outcomes) == list(range(len(golden)))
    for rid, out in router.outcomes.items():
        assert out.reason in S.FINISH_REASONS and out.ok
        assert list(out.tokens) == golden[rid], f"request {rid} diverged"


# -- fault-free identity ------------------------------------------------------

@pytest.mark.parametrize("spec_k", [0, 2])
def test_fault_free_streams_match_colocated(model, jax_runs, spec_k):
    """Greedy and sampled streams, speculation off and on, equal the
    colocated scheduler's, every admission served by the remote
    replica."""
    golden = _golden(model, spec_k=spec_k)
    router = _run(model, jax_runs,
                  "fault_free_spec2" if spec_k else "fault_free")
    assert router.run() == golden
    assert router.stats.remote_prefills == len(_REQS)
    assert router.stats.colocated_prefills == 0
    assert router.stats.failovers == 0
    assert all(h.state == "healthy" for h in router.health.values())
    _assert_all_ok_golden(router, golden)


def test_cross_replica_prefix_dedup(model, jax_runs):
    """The decode replica holds request 0's full first page when request
    1 arrives: its handoff ships one page fewer."""
    golden = _golden(model, _DEDUP)
    router = _run(model, jax_runs, "dedup")
    assert router.run() == golden
    assert router.stats.transfer_pages_deduped == 1
    assert router.stats.remote_prefills == 2


def test_install_writes_the_colocated_slot(model):
    """A routed admission leaves the decode replica's slot as a
    colocated prefill leaves it: the same pages from the same free list,
    the same block-table row (NULL past the prompt's pages, not the
    scratch page a free slot parks on), the same length and the same
    page bytes; and the prefill replica's staging slot leaves nothing
    behind (no pages, no parked row, no staged charge)."""
    prompt = list(range(3, 14))
    ref = _engine(model, S)
    with torch.inference_mode():
        want = ref.prefill(1, prompt)
    inj, trc = S.FaultInjector(), S.Tracer()
    pe, de = _engine(model, S, inj, trc), _engine(model, S, inj, trc)
    router = S.DisaggregatedRouter(pe, de, EOS)
    with torch.inference_mode():
        got = router.engine.prefill(1, prompt)
    assert torch.equal(got, want)
    assert de._slot_pages[1] == ref._slot_pages[1]
    pages = torch.tensor(ref._slot_pages[1])
    for name in ("block_tables", "lengths"):
        assert torch.equal(getattr(de.cache, name), getattr(ref.cache, name))
    assert torch.equal(de.cache.k[:, pages], ref.cache.k[:, pages])
    assert torch.equal(de.cache.v[:, pages], ref.cache.v[:, pages])
    assert not pe._slot_pages[0] and not pe._prefill_parked
    assert pe.pop_admit_charge(0) == 0
    assert router.engine.pop_admit_charge(len(prompt)) == 1
    de.check_invariants()
    pe.check_invariants()


# -- one pinned fault a site --------------------------------------------------

def test_single_send_fault_retries_to_golden(model, jax_runs):
    golden = _golden(model)
    router = _run(model, jax_runs, "send_fault")
    assert router.stats.transfer_retries == 1
    assert router.stats.transfer_failures == 0
    assert router.stats.remote_prefills == len(_REQS)
    _assert_all_ok_golden(router, golden)


def test_single_recv_corruption_quarantines_to_golden(model, jax_runs):
    """One flipped byte in flight: the checksum catches it, the payload
    is quarantined (the golden streams show no corrupt page was
    attended), the retry re-extracts clean tiles."""
    golden = _golden(model)
    router = _run(model, jax_runs, "recv_corrupt")
    assert router.stats.transfer_corrupt == 1
    assert router.stats.transfer_retries == 1
    assert router.stats.transfer_failures == 0
    _assert_all_ok_golden(router, golden)


def test_single_health_probe_fault_recovers(model, jax_runs):
    golden = _golden(model)
    router = _run(model, jax_runs, "health_probe")
    assert router.stats.remote_prefills == len(_REQS)
    assert router.stats.colocated_prefills == 0
    assert router.health["prefill"].state == "healthy"
    assert router.health["prefill"].transitions >= 2
    _assert_all_ok_golden(router, golden)


# -- the degradation ladder ---------------------------------------------------

def test_transfer_budget_exhausted_falls_back_colocated(model, jax_runs):
    """Every attempt of the first handoff dropped: TransferFailed is
    caught and the admission served colocated, the stream golden."""
    golden = _golden(model)
    router = _run(model, jax_runs, "budget_exhausted")
    assert router.stats.transfer_failures == 1
    assert router.stats.colocated_prefills >= 1
    assert "failover" in [e.name for e in router.tracer.events]
    _assert_all_ok_golden(router, golden)


def _typed_exhaustion(model, mod):
    inj = mod.FaultInjector(schedule={"page_recv": (0, 1, 2)})
    src = _engine(model, mod, inj)
    with torch.inference_mode():
        src.prefill(0, [1, 2, 3, 4, 5])
    transfer = mod.PageTransfer(injector=inj, tracer=src.tracer,
                                stats=src.stats, max_retries=2)
    with pytest.raises(mod.TransferCorrupt) as ei:
        transfer.ship(src, [1, 2, 3, 4, 5], src._slot_pages[0],
                      replica="prefill")
    err = ei.value
    k_tile, v_tile, attempts = transfer.ship(
        src, [1, 2, 3, 4, 5], src._slot_pages[0], replica="prefill")
    return err, src, (k_tile, v_tile, attempts)


def test_transfer_corrupt_exhaustion_is_typed(model):
    """Persistent corruption exhausts the budget with a typed
    TransferCorrupt (the JAX package's attempts and pages); a clean
    channel then ships the pages, the source pool's rows verbatim."""
    err, src, (k_tile, v_tile, attempts) = _typed_exhaustion(model, S)
    jerr, jsrc, (jk, _, jattempts) = _typed_exhaustion(model, jax_serving)
    assert (err.attempts, err.pages) == (jerr.attempts, jerr.pages) == (3, 2)
    assert src.stats.as_dict() == jsrc.stats.as_dict()
    assert src.stats.transfer_corrupt == 3
    assert src.stats.transfer_failures == 1
    assert attempts == jattempts == 1 and k_tile.shape == jk.shape
    ids = torch.tensor(src._slot_pages[0])
    assert np.array_equal(k_tile, port_transfer._host(src.cache.k[:, ids]))
    assert np.array_equal(v_tile, port_transfer._host(src.cache.v[:, ids]))


def test_checksum_binds_payload_to_prompt():
    """The chain key is folded into the digest: a payload verifies only
    against its own prompt, and one flipped byte changes it."""
    k = np.zeros((2, 1, 2, 4, 4), np.float32)
    v = np.ones_like(k)
    key_a = S.prefix_page_keys([1, 2, 3, 4], 4)[-1]
    key_b = S.prefix_page_keys([1, 2, 3, 9], 4)[-1]
    assert S.transfer_checksum(k, v, key_a) != S.transfer_checksum(k, v,
                                                                   key_b)
    flipped = np.array(k, copy=True)
    flipped.reshape(-1).view(np.uint8)[3] ^= 0xFF
    assert S.transfer_checksum(k, v, key_a) != \
        S.transfer_checksum(flipped, v, key_a)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_transfer_checksum_equals_jax(dtype):
    """The staged host tiles of the same values are the JAX package's
    bytes (a bf16 tile as its 16-bit view, ml_dtypes' bytes there), so
    the digests are equal."""
    rng = np.random.RandomState(3)
    kv = rng.standard_normal((2, 2, 3, 2, 4, 4)).astype(np.float32)
    key = S.prefix_page_keys(list(range(1, 10)), 4)[-1]
    pk, pv = port_transfer._default_gather(
        *(torch.from_numpy(x).to(getattr(torch, dtype)) for x in kv))
    jk, jv = jax_transfer._default_gather(
        *(jnp.asarray(x, getattr(jnp, dtype)) for x in kv))
    assert pk.tobytes() == np.asarray(jk).tobytes()
    assert pv.tobytes() == np.asarray(jv).tobytes()
    assert S.transfer_checksum(pk, pv, key) \
        == jax_serving.transfer_checksum(jk, jv, key)


def test_remote_replica_down_routes_colocated(model, jax_runs):
    """Persistent probe failures take the prefill replica down (even
    probe indices); later admissions are served colocated."""
    golden = _golden(model)
    router = _run(model, jax_runs, "remote_down")
    assert router.health["prefill"].state == "down"
    assert router.stats.colocated_prefills >= 1
    assert router.stats.failovers == 0
    _assert_all_ok_golden(router, golden)


def test_active_replica_down_mid_stream_fails_over(model, jax_runs):
    """The decode replica dies mid-stream (odd probe indices): the slots
    drain to the queue front, the roles swap, and the resumed streams
    are golden."""
    golden = _golden(model)
    router = _run(model, jax_runs, "active_down")
    assert router.stats.failovers == 1
    assert router.engine.active_name == "prefill"
    names = [e.name for e in router.tracer.events]
    assert "failover" in names and "preempted" in names
    _assert_all_ok_golden(router, golden)


def test_both_replicas_down_keeps_serving(model, jax_runs):
    """The remote goes down first, then the active: no routable target,
    so the incumbent keeps decoding, and its ladder climbs back."""
    golden = _golden(model, _REQS[:2])
    router = _run(model, jax_runs, "both_down")
    assert router.stats.failovers == 0
    assert router.health["prefill"].state == "down"
    assert router.health["decode"].state in ("degraded", "healthy")
    assert router.health["decode"].transitions >= 3
    _assert_all_ok_golden(router, golden)


# -- construction contracts ---------------------------------------------------

def _refusals(model, mod):
    """The pair's typed refusals on ``mod``, each message."""
    jcfg, jp, pcfg, pp = model
    inj, trc = mod.FaultInjector(), mod.Tracer()

    def eng(**kw):
        return _engine(model, mod, kw.pop("injector", inj),
                       kw.pop("tracer", trc), **kw)

    cfg, params = (pcfg, pp) if mod is S else (jcfg, jp)
    dev = {"device": "cpu"} if mod is S else {}
    e = eng()
    cases = [
        lambda: mod.DisaggregatedRouter(e, e, EOS),
        lambda: mod.DisaggregatedRouter(mod.PagedDecodeEngine(
            params, cfg, num_slots=2, max_len=MAX_LEN, num_pages=20,
            page_size=8, buckets=(16, 32), injector=inj, tracer=trc,
            **dev), eng(), EOS),
        lambda: mod.DisaggregatedRouter(eng(injector=mod.FaultInjector()),
                                        eng(), EOS),
        lambda: mod.DisaggregatedRouter(eng(tracer=mod.Tracer()), eng(),
                                        EOS),
        lambda: mod.DisaggregatedRouter(eng(), eng(), EOS, chunk_tokens=4),
        lambda: mod.DisaggregatedRouter(mod.DecodeEngine(
            params, cfg, num_slots=2, max_len=MAX_LEN, injector=inj,
            tracer=trc, **dev), eng(), EOS),
        lambda: mod.DisaggregatedRouter(eng(cache_dtype=(
            torch if mod is S else jnp).int8), eng(), EOS),
    ]
    out = []
    for case in cases:
        with pytest.raises(ValueError) as ei:
            case()
        out.append(str(ei.value))
    return out


def test_router_validates_replica_pair(model):
    """Both packages refuse the same pairs with the same messages: one
    engine twice, another page size, split injectors or tracers,
    chunked prefill, a dense engine, an int8 pool."""
    got = _refusals(model, S)
    assert got == _refusals(model, jax_serving)
    for msg, want in zip(got, ("two engine instances", "agree on page_size",
                               "ONE FaultInjector", "ONE Tracer",
                               "chunked prefill", "paged engine",
                               "int8 page pool")):
        assert want in msg


# -- the randomized multi-fault sweep -----------------------------------------

@pytest.mark.parametrize("seed", SEEDS)
def test_multi_fault_chaos_replays_bit_for_bit(model, jax_runs, seed):
    """The transfer and health sites armed at once (plus decode faults),
    audited every tick: typed outcomes, ok streams golden, degraded ones
    golden prefixes; the run replays exactly and equals the JAX
    package's."""
    golden = _golden(model)
    router = _run(model, jax_runs, f"chaos_seed{seed}")
    assert sorted(router.outcomes) == list(range(len(_REQS)))
    for rid, out in router.outcomes.items():
        assert out.reason in S.FINISH_REASONS
        want = golden[rid]
        if out.ok:
            assert list(out.tokens) == want, f"request {rid} diverged"
        else:
            assert list(out.tokens) == want[:len(out.tokens)]
    replay = _router(model, S, **_SCENARIOS[f"chaos_seed{seed}"])
    assert _summary(replay) == _summary(router)


# -- the tick clock the card must print ---------------------------------------

def _chip_smoke():
    import importlib
    import os
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if repo not in sys.path:
        sys.path.insert(0, repo)
    return importlib.import_module("chip_smoke")


def test_open_loop_ticks_predict_the_card():
    """``chip_smoke.py``'s ``serving_disagg`` (c): the serving mix
    open-loop (``chunked_arrivals``, ``drive_open_loop``) on the card's
    geometry (8 slots, max_len 1024, pages of 64, its pool and buckets)
    through the colocated scheduler and the pair. The work clock counts
    sequential depth and handoff pages, not time or values, so a
    one-layer model on the CPU reads the ticks the card must print
    (``DISAGG_OPEN_LOOP``), the pair's p99 inter-token gap far below the
    colocated one's: a long prompt's prefill no longer stalls the
    co-tenant streams."""
    cs = _chip_smoke()
    cfg = port_gpt.GPTConfig(vocab_size=50304, hidden_size=32, num_layers=1,
                             num_heads=2, ffn_hidden_size=64,
                             max_position_embeddings=cs.MAX_LEN)
    params = port_gpt.init_gpt(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
    prompts = cs.mix_prompts(cfg)
    got, streams = {}, {}
    for route in ("colocated", "pair"):
        inj, trc = S.FaultInjector(), S.Tracer()
        engines = [S.PagedDecodeEngine(
            params, cfg, num_slots=cs.NUM_SLOTS, max_len=cs.MAX_LEN,
            num_pages=cs.PAGED_POOL, page_size=cs.PAGE, buckets=cs.BUCKETS,
            cache_dtype=torch.float32, injector=inj, tracer=trc,
            device="cpu") for _ in range(1 if route == "colocated" else 2)]
        sched = S.ContinuousBatchingScheduler(engines[0], eos_id=EOS) \
            if route == "colocated" \
            else S.DisaggregatedRouter(*engines, eos_id=EOS)
        arrivals = [(t, S.Request(prompt=prompts[i],
                                  max_new_tokens=cs.NEW_TOKENS, seed=i))
                    for t, i in cs.chunked_arrivals(cfg)]
        with torch.inference_mode():
            streams[route] = cs.drive_open_loop(sched, arrivals)
        lat = trc.latency_summary()
        got[route] = {"clock": sched.clock, "ttft_p50": lat["ttft_p50"],
                      "itl_p99": lat["itl_p99"]}
    assert streams["pair"] == streams["colocated"]
    assert got == cs.DISAGG_OPEN_LOOP
    assert got["pair"]["itl_p99"] <= got["colocated"]["itl_p99"]

"""Port parity for the serving fault tier (``apex_tpu_torch.serving.
faults``, the rest of ``health``, the engines' fault sites and the
scheduler's recovery machinery) against the JAX package on the CPU.

- The pure parts: ``fault_draw`` gives the JAX function's draws for a
  grid of (seed, site, index); the injector is inert by default,
  validates its sites and replays a schedule; the error taxonomy and
  ``SITE_CONTRACTS`` are the reference's.
- Every scenario of ``tests/L0/run_serving/test_faults.py`` runs on the
  port (``gpt_tiny`` with RoPE, the params carried across by
  ``params_from_jax``; 2 slots, max_len 32, pages of 4, buckets (16,
  32), a live ``Tracer``) and is held to the reference's degradation
  contract against the port's own fault-free golden: every request ends
  typed, an ok stream equals the golden one, a degraded one is a golden
  prefix, the pool is audited after every tick, a seed replays exactly.
- On five schedules (the multi-fault chaos, the chunked multi-fault
  chaos, the int8 pool's chaos, the model drafter's two-rung ladder and
  the exhausted retry budget) the port's streams, each outcome's
  reason, retries, error class and tick fields, ``ServingStats``,
  ``injector.counts`` and ``tracer.tick_stream()`` equal the JAX
  scheduler's on the same schedule. Each JAX run is made once a module.

``eos_id=-1`` throughout: no token matches it, so golden streams run to
``max_new_tokens`` and prefix assertions are exact. The port runs on
one CPU thread (the module's fixture), which keeps a scheduler run near
0.2 s.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import serving as jax_serving
from apex_tpu.models import gpt as jax_gpt
from apex_tpu.serving import faults as jax_faults
from apex_tpu.serving import health as jax_health
from apex_tpu_torch import serving as S
from apex_tpu_torch.models import gpt as port_gpt
from apex_tpu_torch.serving import faults as port_faults
from apex_tpu_torch.serving import health as port_health
from apex_tpu_torch.serving.cache import RESERVED_PAGES

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


def _engine(model, injector=None, num_slots=2, num_pages=20, **kw):
    """The reference's chaos engine on the port, tracing on."""
    _, _, cfg, params = model
    kw.setdefault("tracer", S.Tracer())
    return S.PagedDecodeEngine(params, cfg, num_slots=num_slots,
                               max_len=MAX_LEN, num_pages=num_pages,
                               page_size=4, buckets=(16, 32),
                               injector=injector, device="cpu", **kw)


def _drive(engine, reqs, **kw):
    sched = S.ContinuousBatchingScheduler(engine, eos_id=EOS, **kw)
    for r in reqs:
        sched.submit(r)
    with torch.inference_mode():
        return sched, sched.run()


def _golden(model, reqs, num_slots=2, **kw):
    return _drive(_engine(model, num_slots=num_slots, **kw), reqs)[1]


def _check_contract(sched, reqs, golden):
    """The degradation contract every chaos run must satisfy."""
    assert sorted(sched.outcomes) == list(range(len(reqs)))
    for rid, out in sched.outcomes.items():
        assert out.reason in S.FINISH_REASONS
        want = golden[rid]
        if out.ok:
            assert list(out.tokens) == want, f"request {rid} diverged"
        else:
            assert list(out.tokens) == want[:len(out.tokens)], \
                f"request {rid}: degraded stream is not a golden prefix"


def _summary(sched):
    """What a chaos run must replay, and equal on both packages."""
    return dict(
        outcomes={rid: (tuple(o.tokens), o.reason, o.retries,
                        type(o.error).__name__, o.ttft_ticks,
                        o.total_ticks, o.prefill_ticks, o.tenant_id)
                  for rid, o in sorted(sched.outcomes.items())},
        stats=sched.stats.as_dict(),
        counts=sched.engine.injector.counts,
        ticks=sched.engine.tracer.tick_stream())


# -- the injector itself ------------------------------------------------------

def test_fault_draw_equals_jax_and_is_pure():
    """Draws are the JAX package's for every site over a grid of seeds
    and indices — the replay contract across packages — and a pure
    function of (seed, site, index)."""
    assert port_faults.SITES == jax_faults.SITES
    for seed in (0, 1, 3, 11, 2 ** 31 - 1):
        for site in port_faults.SITES:
            for i in (0, 1, 5, 63, 1000):
                assert port_faults.fault_draw(seed, site, i) \
                    == jax_faults.fault_draw(seed, site, i)
    draws = {port_faults.fault_draw(s, site, i) for s in (0, 1)
             for site in port_faults.SITES for i in (0, 5)}
    assert len(draws) == 2 * len(port_faults.SITES) * 2
    u01s = [port_faults.fault_draw(0, "pool_alloc", i)[0]
            for i in range(200)]
    assert all(0.0 <= u < 1.0 for u in u01s)
    assert 60 < sum(u < 0.5 for u in u01s) < 140


def test_injector_inert_by_default_and_validates_sites():
    inert = S.FaultInjector()
    assert not inert.armed
    assert all(not inert.fire(s) for s in S.SITES for _ in range(50))
    assert inert.counts == {s: 0 for s in S.SITES}
    assert inert.calls("sample") == 50
    with pytest.raises(ValueError, match="unknown fault sites"):
        S.FaultInjector(rates={"warp_core": 1.0})
    with pytest.raises(ValueError, match="unknown fault sites"):
        S.FaultInjector(schedule={"holodeck": (0,)})
    with pytest.raises(KeyError):
        inert.fire("not_a_site")


def test_injector_schedule_replays_and_equals_jax():
    """Same seed, same visit order -> the same fired pattern, the JAX
    injector's; pinned schedule entries fire regardless of rates."""
    a = S.FaultInjector(seed=11, rates={"decode_exec": 0.3})
    b = S.FaultInjector(seed=11, rates={"decode_exec": 0.3})
    j = jax_serving.FaultInjector(seed=11, rates={"decode_exec": 0.3})
    pat_a = [a.draw("decode_exec") for _ in range(64)]
    assert pat_a == [b.draw("decode_exec") for _ in range(64)]
    assert pat_a == [j.draw("decode_exec") for _ in range(64)]
    assert a.counts == j.counts and any(f for f, _ in pat_a)
    c = S.FaultInjector(seed=12, rates={"decode_exec": 0.3})
    assert pat_a != [c.draw("decode_exec") for _ in range(64)]
    pinned = S.FaultInjector(schedule={"prefill_exec": (2,)})
    assert [pinned.fire("prefill_exec") for _ in range(4)] == [
        False, False, True, False]


def test_error_taxonomy_contract():
    """``SITE_CONTRACTS`` is the reference's and names taxonomy classes;
    every class carries the reference's payload; ``FINISH_REASONS`` and
    ``HEALTH_STATES`` are the reference's; ``ReplicaHealth`` walks the
    reference's ladder with its hysteresis and gauge."""
    assert port_faults.SITE_CONTRACTS == jax_faults.SITE_CONTRACTS
    assert S.FINISH_REASONS == jax_health.FINISH_REASONS
    assert S.HEALTH_STATES == jax_health.HEALTH_STATES
    assert set(port_faults.SITE_CONTRACTS) == set(S.SITES)
    for site, (err_name, sweep) in port_faults.SITE_CONTRACTS.items():
        if err_name is None:
            continue
        cls = getattr(port_health, err_name, None) or (
            S.InjectedFault if err_name == "InjectedFault" else None)
        assert cls is not None, f"{site}: unknown error {err_name}"
        assert issubclass(cls, (S.ServingError, S.InjectedFault))
    cases = [
        (S.ServingError, jax_serving.ServingError, ("boom",), {}),
        (S.ReplicaUnavailable, jax_serving.ReplicaUnavailable,
         ("down",), dict(replica="decode_1")),
        (S.TransferFailed, jax_serving.TransferFailed, ("x",),
         dict(attempts=3, pages=2)),
        (S.TransferCorrupt, jax_serving.TransferCorrupt, ("x",),
         dict(attempts=1, pages=4)),
        (S.ReshardFailed, jax_serving.ReshardFailed, ("x",),
         dict(attempts=2, pages=1, corrupt=True)),
        (S.StreamFailed, jax_serving.StreamFailed, ("x",),
         dict(request_id=3, delivered=5, dropped=2)),
        (S.SloViolation, jax_serving.SloViolation, ("x",),
         dict(tenant="chat", metric="ttft", observed=9, bound=4)),
        (S.RetryBudgetExhausted, jax_serving.RetryBudgetExhausted, ("x",),
         dict(request_id=2, retries=4)),
        (S.LivelockError, jax_serving.LivelockError, ("x",),
         dict(stuck={"queued": [1]}, pool={"num_free": 2})),
        (S.SpillFailed, jax_serving.SpillFailed, ("x",), dict(key="ab")),
        (S.PromoteFailed, jax_serving.PromoteFailed, ("x",),
         dict(key="cd", pages=2)),
        (S.QuotaExhausted, jax_serving.QuotaExhausted, ("x",),
         dict(tenant="s", need=6, quota=4, charged=0))]
    for pc, jc, args, kw in cases:
        p, j = pc(*args, **kw), jc(*args, **kw)
        assert p.payload == j.payload and str(p) == str(j)
        assert [c.__name__ for c in pc.__mro__[:-3]] \
            == [c.__name__ for c in jc.__mro__[:-3]]
    for cls in (S.DeadlineExceeded, S.AdmissionRejected,
                S.NonFiniteLogits):
        assert isinstance(cls("x"), S.ServingError)
    inj = S.InjectedFault("prefill_exec", 4)
    assert (inj.site, inj.index, str(inj)) == (
        "prefill_exec", 4, "injected fault at prefill_exec[4]")
    assert not isinstance(inj, S.ServingError)
    rp, rj = S.MetricsRegistry(), jax_serving.MetricsRegistry()
    hp = S.ReplicaHealth("prefill_0", rp, recover_after=2)
    hj = jax_serving.ReplicaHealth("prefill_0", rj, recover_after=2)
    walk = [False, True, False, False, True, True, True, True, True]
    assert [hp.probe(o) for o in walk] == [hj.probe(o) for o in walk]
    assert (hp.transitions, hp.routable, repr(hp)) \
        == (hj.transitions, hj.routable, repr(hj))
    assert rp.to_prometheus() == rj.to_prometheus()
    with pytest.raises(ValueError, match="recover_after"):
        S.ReplicaHealth("x", recover_after=0)
    out = S.RequestOutcome((1, 2), "retry_budget", error=S.ServingError())
    assert not out.ok and out.tenant_id == "default" and out.slo is None
    assert S.RequestOutcome((1,), "eos").ok


# -- one site at a time, pinned schedules -------------------------------------

def _one(*reqs):
    return [S.Request(**r) for r in reqs]


def test_pool_alloc_fault_recovers_to_golden(model):
    """A transient allocation refusal parks the admission (no retry
    charged) and the next tick succeeds, the golden stream."""
    reqs = _one(dict(prompt=(7, 11, 13, 17, 19), max_new_tokens=4))
    golden = _golden(model, reqs)
    eng = _engine(model, S.FaultInjector(schedule={"pool_alloc": (0,)}))
    sched, outs = _drive(eng, reqs, audit=True)
    assert outs == golden
    assert sched.stats.pool_exhausted == 1 and sched.stats.retries == 0
    assert sched.outcomes[0].ok


def test_cow_clone_fault_preempts_and_recovers(model):
    """A failed copy-on-write clone preempts the slot; the resumed
    stream is the golden one."""
    reqs = _one(dict(prompt=(7, 11, 13, 17, 19), max_new_tokens=4))
    golden = _golden(model, reqs)
    eng = _engine(model, S.FaultInjector(schedule={"cow_clone": (0,)}))
    sched, outs = _drive(eng, reqs, audit=True)
    assert outs == golden
    assert sched.stats.preemptions == 1 and sched.stats.cow_copies >= 1
    assert sched.outcomes[0].ok


def test_prefill_exec_fault_retries_to_golden(model):
    """A transient prefill failure charges one retry and leaves nothing
    behind; the retried admission gives the golden stream."""
    reqs = _one(dict(prompt=(7, 11, 13), max_new_tokens=4))
    golden = _golden(model, reqs)
    eng = _engine(model, S.FaultInjector(schedule={"prefill_exec": (0,)}))
    sched, outs = _drive(eng, reqs, audit=True)
    assert outs == golden
    assert sched.stats.retries == 1
    assert sched.outcomes[0].ok and sched.outcomes[0].retries == 1


def test_dense_engine_prefill_exec_and_decode_nan(model):
    """The dense engine carries the same sites: a prefill fault and a
    NaN decode row retry to the golden streams."""
    _, _, cfg, params = model
    reqs = _one(dict(prompt=(7, 11, 13), max_new_tokens=5),
                dict(prompt=(23, 29), max_new_tokens=5))

    def dense(injector=None):
        return S.DecodeEngine(params, cfg, num_slots=2, max_len=MAX_LEN,
                              buckets=(16, 32), injector=injector,
                              device="cpu")

    golden = _drive(dense(), reqs)[1]
    sched, outs = _drive(dense(S.FaultInjector(schedule={
        "prefill_exec": (0,), "decode_exec": (1,)})), reqs, audit=True)
    assert outs == golden
    assert sched.stats.retries == 2 and sched.stats.nan_events == 1


@pytest.mark.parametrize("budget", [0, 3], ids=["no_retry", "retry"])
def test_decode_nan_quarantine_keeps_cotenant_bit_identical(model, budget):
    """A NaN decode row quarantines ONE slot. With no retry budget the
    victim ends typed, its tokens the golden first token, the co-tenant
    golden; with the default budget both streams are golden."""
    reqs = _one(dict(prompt=(7, 11, 13), max_new_tokens=5),
                dict(prompt=(23, 29), max_new_tokens=5))
    golden = _golden(model, reqs)
    eng = _engine(model, S.FaultInjector(schedule={"decode_exec": (0,)}))
    sched, outs = _drive(eng, reqs, audit=True, max_retries=budget)
    assert sched.stats.nan_events == 1
    if budget:
        assert outs == golden
        assert all(o.ok for o in sched.outcomes.values())
        return
    bad = [rid for rid, o in sched.outcomes.items() if not o.ok]
    assert len(bad) == 1
    victim = sched.outcomes[bad[0]]
    assert victim.reason == "retry_budget"
    assert isinstance(victim.error, S.RetryBudgetExhausted)
    assert list(victim.tokens) == golden[bad[0]][:1]
    ok = (set(sched.outcomes) - set(bad)).pop()
    assert list(sched.outcomes[ok].tokens) == golden[ok]


def test_sample_fault_at_admission_recovers(model):
    """An out-of-vocabulary first token is caught by the admission gate;
    the request retries and matches golden."""
    reqs = _one(dict(prompt=(7, 11, 13), max_new_tokens=4,
                     temperature=0.8, seed=5))
    golden = _golden(model, reqs)
    eng = _engine(model, S.FaultInjector(schedule={"sample": (0,)}))
    sched, outs = _drive(eng, reqs, audit=True)
    assert outs == golden
    assert sched.stats.bad_samples == 1
    assert sched.outcomes[0].ok and sched.outcomes[0].retries == 1


_SPEC_REQS = (dict(prompt=(7, 11, 7, 11, 7), max_new_tokens=6),
              dict(prompt=(5, 3, 5, 3), max_new_tokens=6, temperature=0.8,
                   seed=3))


def _spec_engine(model, injector=None, spec_k=3, num_pages=20,
                 drafter=False, tree=False, **kw):
    _, _, cfg, params = model
    dm = S.DraftModel(params, cfg, num_slots=2, max_len=MAX_LEN,
                      device="cpu") if drafter else None
    return S.PagedDecodeEngine(params, cfg, num_slots=2, max_len=MAX_LEN,
                               num_pages=num_pages, page_size=4,
                               buckets=(16, 32), spec_k=spec_k,
                               draft_model=dm, tree_spec=tree,
                               injector=injector, device="cpu", **kw)


def test_draft_fault_degrades_to_plain_and_recovers(model):
    """A mid-stream n-gram draft fault degrades that slot to an empty
    draft for the tick (no retry charged); the streams stay golden."""
    reqs = _one(*_SPEC_REQS)
    plain = _golden(model, reqs)
    golden = _drive(_spec_engine(model), reqs, audit=True)[1]
    assert golden == plain
    sched, outs = _drive(_spec_engine(model, S.FaultInjector(
        schedule={"draft_exec": (1, 4)})), reqs, audit=True)
    assert outs == golden
    assert sched.stats.draft_faults == 2 and sched.stats.retries == 0
    assert all(o.ok for o in sched.outcomes.values())
    assert sched.stats.tokens_drafted > 0


@pytest.mark.parametrize("tree", [False, True], ids=["linear", "tree"])
def test_model_draft_fault_ladder_degrades_and_recovers(model, tree):
    """The model drafter's ``draft_exec`` ladder: one fired draw falls
    back to n-gram drafts for the tick (one draft fault), a fired pair
    makes a plain tick (two); both recover to the golden streams, no
    retry charged, linear and tree."""
    reqs = _one(*_SPEC_REQS)
    golden = _drive(_spec_engine(model, drafter=True, tree=tree), reqs,
                    audit=True)[1]
    assert golden == _golden(model, reqs)
    for pinned, faults in (((1,), 1), ((1, 2), 2)):
        if tree and len(pinned) == 1:
            continue
        sched, outs = _drive(_spec_engine(model, S.FaultInjector(
            schedule={"draft_exec": pinned}), drafter=True, tree=tree),
            reqs, audit=True)
        assert outs == golden
        assert sched.stats.draft_faults == faults
        assert sched.stats.retries == 0


@pytest.mark.parametrize("seed", [0, 1])
def test_spec_multi_fault_chaos_is_typed_prefixed_and_replayable(
        model, seed):
    """Randomized faults at every site, draft_exec included, against
    the speculative scheduler: typed outcomes, golden-prefix
    degradation, exact replay."""
    reqs = _one(dict(prompt=(7, 11, 7, 11), max_new_tokens=5),
                dict(prompt=(17, 19, 17, 19), max_new_tokens=5,
                     temperature=0.8, seed=3),
                dict(prompt=(7, 11, 13, 29), max_new_tokens=4),
                dict(prompt=(5, 3, 5, 3), max_new_tokens=6,
                     temperature=0.7, seed=9))
    golden = _golden(model, reqs)
    rates = {"pool_alloc": 0.1, "cow_clone": 0.2, "prefill_exec": 0.15,
             "decode_exec": 0.1, "sample": 0.1, "draft_exec": 0.3}

    def chaos_run():
        return _drive(_spec_engine(model, S.FaultInjector(
            seed=seed, rates=rates), num_pages=14, tracer=S.Tracer()),
            reqs, audit=True)[0]

    sched = chaos_run()
    _check_contract(sched, reqs, golden)
    assert _summary(chaos_run()) == _summary(sched)


# -- typed terminations -------------------------------------------------------

def test_retry_budget_exhausted_surfaces_typed(model):
    """A persistently failing request ends with ``RetryBudgetExhausted``
    carrying its id and retry count; it never wedges the scheduler."""
    sched, outs = _retry_budget_run(model)
    assert outs == [[]]
    out = sched.outcomes[0]
    assert out.reason == "retry_budget" and not out.ok
    assert isinstance(out.error, S.RetryBudgetExhausted)
    assert out.error.request_id == 0 and out.retries == 3
    assert "flight" in out.error.payload


def test_deadline_exceeded_queued_and_mid_decode(model):
    """Deadlines are scheduler ticks. A request expiring queued ends
    empty; one expiring mid-decode keeps a golden prefix."""
    probe = S.Request(prompt=(7, 11, 13), max_new_tokens=8)
    golden = _golden(model, [probe], num_slots=1)
    hog = S.Request(prompt=(23, 29), max_new_tokens=8)
    starved = dataclasses.replace(probe, deadline_ticks=2)
    sched, _ = _drive(_engine(model, num_slots=1), [hog, starved])
    out = sched.outcomes[1]
    assert out.reason == "deadline"
    assert isinstance(out.error, S.DeadlineExceeded)
    assert out.tokens == () and sched.stats.deadline_expired == 1
    cut = dataclasses.replace(probe, deadline_ticks=3)
    sched2, _ = _drive(_engine(model, num_slots=1), [cut])
    out2 = sched2.outcomes[0]
    assert out2.reason == "deadline"
    assert 0 < len(out2.tokens) < len(golden[0])
    assert list(out2.tokens) == golden[0][:len(out2.tokens)]


def test_admission_backpressure(model):
    """A bounded queue sheds load typed; accepted requests are
    unaffected, and a drained queue has room again."""
    sched = S.ContinuousBatchingScheduler(_engine(model), eos_id=EOS,
                                          max_queue=2)
    sched.submit(S.Request(prompt=(7, 11), max_new_tokens=2))
    sched.submit(S.Request(prompt=(13, 17), max_new_tokens=2))
    with pytest.raises(S.AdmissionRejected):
        sched.submit(S.Request(prompt=(19, 23), max_new_tokens=2))
    assert sched.stats.admission_rejections == 1
    with torch.inference_mode():
        outs = sched.run()
    assert len(outs) == 2 and all(len(t) == 2 for t in outs)
    sched.submit(S.Request(prompt=(19, 23), max_new_tokens=2))


def test_livelock_watchdog_raises_with_diagnostics(model):
    """Every page always claims to need a copy on an exact-fit pool: the
    watchdog raises ``LivelockError`` with the stuck set and a pool
    snapshot (nothing leaked) instead of spinning."""
    _, _, cfg, params = model
    eng = S.PagedDecodeEngine(params, cfg, num_slots=1, max_len=MAX_LEN,
                              num_pages=2 + RESERVED_PAGES, page_size=4,
                              buckets=(16, 32), device="cpu")
    eng.pool.needs_copy = lambda page: True
    sched = S.ContinuousBatchingScheduler(eng, eos_id=EOS,
                                          watchdog_limit=8)
    sched.submit(S.Request(prompt=(7, 11, 13, 17, 19), max_new_tokens=3))
    with pytest.raises(S.LivelockError) as exc, torch.inference_mode():
        sched.run()
    stuck = exc.value.stuck
    assert stuck["queued"] == [0] or stuck["slots"] == {0: 0}
    assert exc.value.pool["num_free"] == 2
    assert exc.value.pool["refcounts"] == {}
    assert exc.value.pool["slot_pages"] == [[]]


def test_invariant_audit_catches_corruption(model):
    """The audit detects broken books on the host and on the device."""
    eng = _engine(model, num_slots=1)
    with torch.inference_mode():
        eng.prefill(0, (7, 11, 13, 17, 19))
    eng.check_invariants()
    eng._slot_pages[0].append(eng._slot_pages[0][0])
    with pytest.raises(S.PoolInvariantError, match="out of balance"):
        eng.check_invariants()
    eng._slot_pages[0].pop()
    eng.check_invariants()
    eng.cache.block_tables[0, 0] = 9
    with pytest.raises(S.PoolInvariantError, match="device row"):
        eng.check_invariants()


def test_pool_exhaustion_with_every_slot_free_raises_typed(model):
    """With no injector armed, a head the pool cannot admit even with
    every slot free is a submit-validation bug and raises typed; with
    an injector armed it is a transient refusal and waits."""
    eng = _engine(model, num_pages=RESERVED_PAGES + 3)
    sched = S.ContinuousBatchingScheduler(eng, eos_id=EOS)
    sched.submit(S.Request(prompt=(7, 11, 13), max_new_tokens=2))
    eng.pool.alloc = lambda: None
    with pytest.raises(S.PoolExhausted, match="every slot free"), \
            torch.inference_mode():
        sched.step()
    armed = _engine(model, S.FaultInjector(schedule={"pool_alloc": (0,)}))
    sched = S.ContinuousBatchingScheduler(armed, eos_id=EOS)
    sched.submit(S.Request(prompt=(7, 11, 13), max_new_tokens=2))
    with torch.inference_mode():
        sched.step()
    assert sched.stats.pool_exhausted == 1 and not sched.outcomes


# -- randomized multi-fault chaos ---------------------------------------------

_MULTI = (dict(prompt=(7, 11, 13), max_new_tokens=5),
          dict(prompt=(17, 19), max_new_tokens=5, temperature=0.8, seed=3),
          dict(prompt=(7, 11, 13, 29), max_new_tokens=4),
          dict(prompt=(23, 29, 31, 37, 41), max_new_tokens=6),
          dict(prompt=(7, 11, 13), max_new_tokens=5, temperature=0.7,
               seed=9))
_RATES = {"pool_alloc": 0.1, "cow_clone": 0.2, "prefill_exec": 0.15,
          "decode_exec": 0.1, "sample": 0.1}


def _multi_run(model, seed, cls=S, **kw):
    """The reference's multi-fault chaos run on either package."""
    jcfg, jp, pcfg, pp = model
    reqs = [cls.Request(**r) for r in _MULTI]
    if cls is S:
        eng = _engine(model, S.FaultInjector(seed=seed, rates=_RATES),
                      num_pages=12, **kw)
        return _drive(eng, reqs, audit=True)[0]
    eng = jax_serving.PagedDecodeEngine(
        jp, jcfg, num_slots=2, max_len=MAX_LEN, num_pages=12, page_size=4,
        buckets=(16, 32), tracer=jax_serving.Tracer(),
        injector=jax_serving.FaultInjector(seed=seed, rates=_RATES), **kw)
    sched = jax_serving.ContinuousBatchingScheduler(eng, eos_id=EOS,
                                                    audit=True)
    for r in reqs:
        sched.submit(r)
    sched.run()
    return sched


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_multi_fault_chaos_is_typed_prefixed_and_replayable(model, seed):
    """Randomized faults at every single-engine site at once, audited
    every tick: typed outcomes, golden or golden-prefix streams, exact
    replay of outcomes, stats, injector counts and tick stream."""
    reqs = [S.Request(**r) for r in _MULTI]
    golden = _golden(model, reqs)
    sched = _multi_run(model, seed)
    _check_contract(sched, reqs, golden)
    assert _summary(_multi_run(model, seed)) == _summary(sched)


_CHUNKY = (7, 11, 13, 17, 19, 23, 29, 31, 37, 41)   # 10 tokens, 3 chunks


@pytest.mark.parametrize("index,sampled", [(1, False), (2, True)],
                         ids=["mid_prompt", "final_chunk"])
def test_chunk_prefill_fault_requeues_clean(model, index, sampled):
    """A fault on the second (mid-prompt) or the final chunk of a staged
    prefill frees the slot leak-free, charges one retry, and the retry
    from the prompt's head commits the golden stream."""
    reqs = _one(dict(prompt=_CHUNKY, max_new_tokens=4,
                     temperature=0.8 if sampled else 0.0, seed=5))
    golden = _golden(model, reqs)
    eng = _engine(model, S.FaultInjector(
        schedule={"chunk_prefill_exec": (index,)}))
    sched, outs = _drive(eng, reqs, audit=True, chunk_tokens=4)
    assert outs == golden
    assert sched.stats.retries == 1
    assert sched.outcomes[0].ok and sched.outcomes[0].retries == 1
    eng.check_invariants()
    assert all(not pages for pages in eng._slot_pages)


def test_chunk_prefill_fault_exhausts_retry_budget_typed(model):
    """A persistently faulting chunk ends typed with an empty stream and
    leaks nothing."""
    reqs = _one(dict(prompt=_CHUNKY, max_new_tokens=4))
    eng = _engine(model, S.FaultInjector(
        schedule={"chunk_prefill_exec": range(20)}))
    sched, outs = _drive(eng, reqs, audit=True, chunk_tokens=4,
                         max_retries=2)
    assert outs == [[]]
    out = sched.outcomes[0]
    assert out.reason == "retry_budget" and not out.ok
    assert isinstance(out.error, S.RetryBudgetExhausted)
    eng.check_invariants()
    assert all(not pages for pages in eng._slot_pages)


_CHUNKED = (dict(prompt=_CHUNKY, max_new_tokens=5),
            dict(prompt=_CHUNKY[:7], max_new_tokens=5, temperature=0.8,
                 seed=3),
            dict(prompt=(5, 3), max_new_tokens=4),
            dict(prompt=_CHUNKY + (43, 47), max_new_tokens=4,
                 temperature=0.7, seed=9))
_CHUNK_RATES = {"pool_alloc": 0.1, "cow_clone": 0.2,
                "chunk_prefill_exec": 0.2, "decode_exec": 0.1,
                "sample": 0.1}


def _chunked_run(model, seed, cls=S):
    jcfg, jp, _, _ = model
    reqs = [cls.Request(**r) for r in _CHUNKED]
    if cls is S:
        eng = _engine(model, S.FaultInjector(seed=seed, rates=_CHUNK_RATES),
                      num_pages=14)
        return _drive(eng, reqs, audit=True, chunk_tokens=4)[0]
    eng = jax_serving.PagedDecodeEngine(
        jp, jcfg, num_slots=2, max_len=MAX_LEN, num_pages=14, page_size=4,
        buckets=(16, 32), tracer=jax_serving.Tracer(),
        injector=jax_serving.FaultInjector(seed=seed, rates=_CHUNK_RATES))
    sched = jax_serving.ContinuousBatchingScheduler(
        eng, eos_id=EOS, audit=True, chunk_tokens=4)
    for r in reqs:
        sched.submit(r)
    sched.run()
    return sched


@pytest.mark.parametrize("seed", [0, 1])
def test_chunked_multi_fault_chaos_is_typed_prefixed_and_replayable(
        model, seed):
    """The randomized sweep with chunked prefill on and the
    chunk_prefill_exec site armed: typed outcomes against the
    monolithic golden, exact replay."""
    reqs = [S.Request(**r) for r in _CHUNKED]
    golden = _golden(model, reqs)
    sched = _chunked_run(model, seed)
    _check_contract(sched, reqs, golden)
    assert sched.engine.injector.counts["chunk_prefill_exec"] > 0 \
        or sched.stats.prefill_chunks > 0
    assert _summary(_chunked_run(model, seed)) == _summary(sched)


_INT8 = (dict(prompt=(7, 11, 13), max_new_tokens=5),
         dict(prompt=(17, 19), max_new_tokens=5, temperature=0.8, seed=3),
         dict(prompt=(23, 29, 31, 37, 41), max_new_tokens=6),
         dict(prompt=(7, 11, 13), max_new_tokens=5, temperature=0.7,
              seed=9))


def _int8_run(model, cls=S, injector=True):
    jcfg, jp, _, _ = model
    reqs = [cls.Request(**r) for r in _INT8]
    if cls is S:
        inj = S.FaultInjector(seed=1, rates=_RATES) if injector else None
        eng = _engine(model, inj, num_pages=12 if injector else 20,
                      cache_dtype=torch.int8)
        return _drive(eng, reqs, audit=True)[0]
    eng = jax_serving.PagedDecodeEngine(
        jp, jcfg, num_slots=2, max_len=MAX_LEN, num_pages=12, page_size=4,
        buckets=(16, 32), tracer=jax_serving.Tracer(),
        cache_dtype=jnp.int8,
        injector=jax_serving.FaultInjector(seed=1, rates=_RATES))
    sched = jax_serving.ContinuousBatchingScheduler(eng, eos_id=EOS,
                                                    audit=True)
    for r in reqs:
        sched.submit(r)
    sched.run()
    return sched


def test_multi_fault_chaos_on_int8_pool(model):
    """One seed of the sweep on the int8 page pool: the contract and
    exact replay with per-page scales riding the clone, preemption and
    retry paths (golden: the int8 engine's own fault-free run)."""
    reqs = [S.Request(**r) for r in _INT8]
    golden = [list(o.tokens) for _, o in sorted(
        _int8_run(model, injector=False).outcomes.items())]
    sched = _int8_run(model)
    _check_contract(sched, reqs, golden)
    assert _summary(_int8_run(model)) == _summary(sched)


def _retry_budget_run(model, cls=S):
    jcfg, jp, _, _ = model
    reqs = [cls.Request(prompt=(7, 11, 13), max_new_tokens=4)]
    sched_kw = dict(audit=True, max_retries=2)
    if cls is S:
        eng = _engine(model, S.FaultInjector(
            schedule={"prefill_exec": range(10)}))
        return _drive(eng, reqs, **sched_kw)
    eng = jax_serving.PagedDecodeEngine(
        jp, jcfg, num_slots=2, max_len=MAX_LEN, num_pages=20, page_size=4,
        buckets=(16, 32), tracer=jax_serving.Tracer(),
        injector=jax_serving.FaultInjector(
            schedule={"prefill_exec": range(10)}))
    sched = jax_serving.ContinuousBatchingScheduler(eng, eos_id=EOS,
                                                    **sched_kw)
    for r in reqs:
        sched.submit(r)
    return sched, sched.run()


def _ladder_run(model, cls=S):
    jcfg, jp, _, _ = model
    pinned = {"draft_exec": (1, 2)}
    reqs = [cls.Request(**r) for r in _SPEC_REQS]
    if cls is S:
        eng = _spec_engine(model, S.FaultInjector(schedule=pinned),
                           drafter=True, tracer=S.Tracer())
        return _drive(eng, reqs, audit=True)[0]
    dm = jax_serving.DraftModel(jp, jcfg, num_slots=2, max_len=MAX_LEN)
    eng = jax_serving.PagedDecodeEngine(
        jp, jcfg, num_slots=2, max_len=MAX_LEN, num_pages=20, page_size=4,
        buckets=(16, 32), spec_k=3, draft_model=dm,
        tracer=jax_serving.Tracer(),
        injector=jax_serving.FaultInjector(schedule=pinned))
    sched = jax_serving.ContinuousBatchingScheduler(eng, eos_id=EOS,
                                                    audit=True)
    for r in reqs:
        sched.submit(r)
    sched.run()
    return sched


# -- against the JAX package, on the same schedules ---------------------------

_RUNS = {
    "multi_fault_seed0": lambda m, cls: _multi_run(m, 0, cls),
    "chunked_multi_fault_seed0": lambda m, cls: _chunked_run(m, 0, cls),
    "int8_pool_chaos": lambda m, cls: _int8_run(m, cls),
    "model_draft_ladder": lambda m, cls: _ladder_run(m, cls),
    "retry_budget": lambda m, cls: _retry_budget_run(m, cls)[0],
}


@pytest.fixture(scope="module")
def jax_runs():
    return {}


@pytest.mark.parametrize("name", sorted(_RUNS))
def test_chaos_schedule_equals_jax(model, jax_runs, name):
    """The same schedule on both packages: the streams, each outcome's
    reason, retries, error class and tick fields, ``ServingStats``,
    ``injector.counts`` and the tracer's tick stream are equal."""
    if name not in jax_runs:
        jax_runs[name] = _summary(_RUNS[name](model, jax_serving))
    want = jax_runs[name]
    got = _summary(_RUNS[name](model, S))
    assert got["outcomes"] == want["outcomes"]
    assert got["stats"] == want["stats"]
    assert got["counts"] == want["counts"]
    assert got["ticks"] == want["ticks"]
    assert sum(got["counts"].values()) > 0

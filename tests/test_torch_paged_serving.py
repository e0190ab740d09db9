"""Port parity for paged serving: ``apex_tpu_torch``'s
``PagedDecodeEngine`` under ``ContinuousBatchingScheduler`` against the
JAX package's on ``gpt_tiny`` (page size 4), with the JAX parameters
carried across by ``params_from_jax``. The port runs on the CPU (the
plain versions of its kernels); the JAX side runs as its own serving
tests run it (Pallas in interpret mode).

Request mixes share prompt prefixes (whole pages, and an exact partial
last page), mix greedy and seeded-sampled requests, and run on fp32,
bf16 and int8 pools, on weight-only int8 params, with RoPE, and on a
pool small enough to preempt. Committed streams, outcomes and tick
accounting are compared exactly, as are the allocator's final state and
its copy-on-write and preemption counts; ``check_invariants()`` holds
after every port tick. Greedy tokens are guarded by a top-2 margin of
1e-3 on the port's full forward (a near-tie could flip under fp32
reordering)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.models import gpt as jax_gpt
from apex_tpu import serving as jax_serving
from apex_tpu.quant import quantize_params as jax_quantize_params
from apex_tpu_torch.models import gpt as port_gpt
from apex_tpu_torch import serving as port_serving
from apex_tpu_torch.quant import quantize_params as port_quantize_params
from apex_tpu_torch.serving.cache import RESERVED_PAGES

S_MAX, PAGE, BUCKETS = 48, 4, (16, 32, 48)
_EOS = 7
KV8_MAX_ABS = 0.02   # the JAX package's kv8 envelope on gpt_tiny


def _cfgs(use_rope):
    return (dataclasses.replace(jax_gpt.gpt_tiny(), use_rope=use_rope),
            dataclasses.replace(port_gpt.gpt_tiny(), use_rope=use_rope))


@pytest.fixture(scope="module")
def jax_params():
    # keys 0 (learned) and 3 (RoPE): the greedy choices of these mixes
    # clear the 1e-3 margin guard
    return {False: jax_gpt.init_gpt(jax.random.PRNGKey(0), _cfgs(False)[0]),
            True: jax_gpt.init_gpt(jax.random.PRNGKey(3), _cfgs(True)[0])}


def _port(tree):
    return port_gpt.params_from_jax(jax.tree.map(np.asarray, tree), "cpu")


def _mix(vocab):
    """Two prefixes of 8 tokens (two whole pages) with private suffixes,
    one 6-token prompt sent twice (its partial last page shared exactly),
    greedy and sampled (temperature 0.8, seed = index)."""
    rng = np.random.RandomState(5)
    pa, pb = (tuple(int(t) for t in rng.randint(8, vocab, size=8))
              for _ in range(2))
    six = tuple(int(t) for t in rng.randint(8, vocab, size=6))
    prompts = [pa + (9, 10, 11), pb, pa + (12,), six, pb + (13, 14, 15, 16,
               17), six, pa]
    new = (6, 9, 5, 8, 4, 7, 6)
    return [(p, m, 0.8 if i % 3 == 1 else 0.0)
            for i, (p, m) in enumerate(zip(prompts, new))]


def _jax_run(params, cfg, reqs, **kw):
    eng = jax_serving.PagedDecodeEngine(params, cfg, num_slots=2,
                                        max_len=S_MAX, buckets=BUCKETS,
                                        **kw)
    sched = jax_serving.ContinuousBatchingScheduler(eng, eos_id=_EOS,
                                                    audit=True)
    for p, m, t in reqs:
        sched.submit(jax_serving.Request(prompt=p, max_new_tokens=m,
                                         temperature=t, seed=len(p)))
    return sched.run(), sched, eng


def _port_run(params, cfg, reqs, engine=None, **kw):
    eng = (engine or port_serving.PagedDecodeEngine)(
        params, cfg, num_slots=2, max_len=S_MAX, buckets=BUCKETS,
        device="cpu", **kw)
    sched = port_serving.ContinuousBatchingScheduler(eng, eos_id=_EOS)
    for p, m, t in reqs:
        sched.submit(port_serving.Request(prompt=p, max_new_tokens=m,
                                          temperature=t, seed=len(p)))
    with torch.inference_mode():
        while sched.busy:
            sched.step()
            assert eng.check_invariants()
    return sched.run(), sched, eng


def _outcomes(sched, n):
    return [(o.tokens, o.reason, o.ttft_ticks, o.total_ticks,
             o.prefill_ticks) for o in (sched.outcomes[i] for i in range(n))]


def _margin_guard(pp, pcfg, reqs, streams):
    """Every greedy choice wins by a clear top-2 margin on the port's
    fp32 full forward."""
    with torch.inference_mode():
        for (p, _, t), toks in zip(reqs, streams):
            if t > 0:
                continue
            seq = torch.tensor([list(p) + toks[:-1]])
            hidden = port_gpt.apply_gpt_unsharded(pp, pcfg, seq)
            table = pp["embedding"]["word"]["embedding"]
            rows = torch.matmul(hidden, table.float().t())[0, len(p) - 1:]
            top2 = rows.topk(2).values
            assert float((top2[:, 0] - top2[:, 1]).min()) > 1e-3


CASES = {  # name -> (use_rope, cache dtype, w8 params, num_pages)
    "f32_pool": (False, "float32", False, 40),
    "bf16_pool": (False, "bfloat16", False, 40),
    "int8_pool": (False, "int8", False, 40),
    "w8_params": (False, "float32", True, 40),
    "w8_params_int8_pool": (True, "int8", True, 40),
    "rope_f32_pool": (True, "float32", False, 40),
    "rope_tight_pool": (True, "float32", False, 2 + 6),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_paged_streams_identical_to_jax(jax_params, case):
    use_rope, dt, w8, num_pages = CASES[case]
    cfg, pcfg = _cfgs(use_rope)
    jp = jax_params[use_rope]
    pp = _port(jp)
    reqs = _mix(cfg.vocab_size)
    kw = dict(num_pages=num_pages, page_size=PAGE)
    want, jsched, jeng = _jax_run(
        jax_quantize_params(jp) if w8 else jp, cfg, reqs,
        cache_dtype=getattr(jnp, dt), **kw)
    got, psched, peng = _port_run(
        port_quantize_params(pp) if w8 else pp, pcfg, reqs,
        cache_dtype=getattr(torch, dt), **kw)
    if not w8:
        _margin_guard(pp, pcfg, reqs, want)
    assert got == want
    assert _outcomes(psched, len(reqs)) == _outcomes(jsched, len(reqs))
    assert psched.decode_steps == jsched.stats.plain_ticks
    assert peng.pool.num_cached == jeng.pool.num_cached > 0
    ps = peng.stats
    assert (ps.cow_copies, ps.preemptions, ps.pool_exhausted) == (
        jeng.stats.cow_copies, jeng.stats.preemptions,
        jeng.stats.pool_exhausted)
    assert peng.pool_snapshot() == jeng.pool_snapshot()
    assert peng.pool_gauges() == jeng.pool_gauges()
    if case == "rope_tight_pool":
        assert peng.stats.preemptions > 0 and peng.stats.pool_exhausted > 0


def test_paged_streams_identical_to_dense(jax_params):
    """The port's paged engine commits the port's dense engine's
    streams on the same mix (fp32 cache and pool)."""
    cfg, pcfg = _cfgs(False)
    pp = _port(jax_params[False])
    reqs = _mix(cfg.vocab_size)
    dense, dsched, _ = _port_run(pp, pcfg, reqs,
                                 engine=port_serving.DecodeEngine,
                                 cache_dtype=torch.float32)
    paged, psched, _ = _port_run(pp, pcfg, reqs, num_pages=40,
                                 page_size=PAGE, cache_dtype=torch.float32)
    assert paged == dense
    assert _outcomes(psched, len(reqs)) == _outcomes(dsched, len(reqs))


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_preemption_matches_roomy_pool_and_jax(jax_params, temperature):
    """The JAX skill's case: two 5-token prompts with 8 new tokens on a
    ``num_pages=7, page_size=4`` pool (5 usable pages): both cross a
    page boundary at position 8 with one page left, so one is preempted,
    requeued with its tokens and resumed; the streams equal a roomy
    pool's and the JAX scheduler's."""
    cfg, pcfg = _cfgs(True)
    jp = jax_params[True]
    pp = _port(jp)
    reqs = [((7, 11, 13, 17, 19), 8, temperature),
            ((23, 29, 31, 37, 41), 8, temperature)]
    kw = dict(page_size=PAGE, cache_dtype=torch.float32)
    roomy, _, _ = _port_run(pp, pcfg, reqs, num_pages=20, **kw)
    tight, psched, peng = _port_run(pp, pcfg, reqs, num_pages=7, **kw)
    want, jsched, jeng = _jax_run(jp, cfg, reqs, num_pages=7,
                                  page_size=PAGE, cache_dtype=jnp.float32)
    assert peng.stats.preemptions > 0
    assert tight == roomy == want
    assert peng.stats.preemptions == jeng.stats.preemptions
    assert _outcomes(psched, 2) == _outcomes(jsched, 2)


def test_free_order_gives_the_same_logits_bit_for_bit(jax_params):
    """Placement: the same mix with the free list reversed commits the
    same streams, and a teacher-forced decode gives the same bits."""
    cfg, pcfg = _cfgs(True)
    pp = _port(jax_params[True])
    reqs = _mix(cfg.vocab_size)
    usable = list(range(RESERVED_PAGES, 40))
    runs = [_port_run(pp, pcfg, reqs, num_pages=40, page_size=PAGE,
                      cache_dtype=torch.bfloat16, free_order=order)[0]
            for order in (None, usable[::-1])]
    assert runs[0] == runs[1]
    logits = []
    for order in (None, usable[::-1]):
        eng = port_serving.PagedDecodeEngine(
            pp, pcfg, num_slots=2, max_len=S_MAX, num_pages=40,
            page_size=PAGE, buckets=BUCKETS, cache_dtype=torch.bfloat16,
            free_order=order, device="cpu")
        with torch.inference_mode():
            rows = [eng.prefill(1, reqs[0][0])[0]]
            for t in range(len(reqs[0][0]), len(reqs[0][0]) + 6):
                assert eng.prepare_decode({1: t}) == []
                rows.append(eng.decode([0, 5 + t], [False, True])[1])
        assert eng._slot_pages[1] != [] and eng.check_invariants()
        logits.append(torch.stack(rows))
    assert torch.equal(logits[0], logits[1])


def test_prefix_pages_stored_once_and_cow_keeps_them(jax_params):
    """Two slots admitted with one 6-token prompt hold the same pages
    (the partial last page too); their first appends clone it (two COW
    copies) and each slot's logits equal a run where it decodes alone,
    bit for bit; the registry keeps the original."""
    cfg, pcfg = _cfgs(True)
    pp = _port(jax_params[True])
    prompt = [5, 7, 11, 13, 17, 19]

    def engine():
        return port_serving.PagedDecodeEngine(
            pp, pcfg, num_slots=2, max_len=S_MAX, num_pages=12,
            page_size=PAGE, buckets=BUCKETS, cache_dtype=torch.float32,
            device="cpu")

    def alone(slot, token):
        eng = engine()
        pre = eng.prefill(slot, prompt)
        assert eng.prepare_decode({slot: len(prompt)}) == []
        toks, act = [0, 0], [False, False]
        toks[slot], act[slot] = token, True
        return pre, eng.decode(toks, act)[slot]

    with torch.inference_mode():
        ref = [alone(0, 31), alone(1, 37)]
        eng = engine()
        pre = [eng.prefill(0, prompt)]
        free = eng.pool.num_free
        pre.append(eng.prefill(1, prompt))
        assert eng.pool.num_free == free          # nothing allocated
        assert eng._slot_pages[0] == eng._slot_pages[1]
        shared = eng._slot_pages[0][1]
        assert eng.pool.refcount(shared) == 3     # 2 slots + registry
        assert eng.prepare_decode({0: 6, 1: 6}) == []
        assert eng.stats.cow_copies == 2 and eng.pool.refcount(shared) == 1
        step = eng.decode([31, 37], [True, True])
        eng.check_invariants()
    for i in range(2):
        assert torch.equal(pre[i], ref[i][0])
        assert torch.equal(step[i], ref[i][1])


def test_pool_errors_match_jax(jax_params):
    """``PoolExhausted`` from a prefill the pool cannot cover (every
    reference rolled back), the scheduler's when even an empty batch
    cannot admit, and the oversized ``page_demand``: the reference's
    types, fields and messages."""
    cfg, pcfg = _cfgs(True)
    jp = jax_params[True]
    pp = _port(jp)
    kw = dict(num_slots=2, max_len=S_MAX, num_pages=RESERVED_PAGES + 3,
              page_size=PAGE, buckets=BUCKETS, prefix_sharing=False)
    engs = (jax_serving.PagedDecodeEngine(jp, cfg,
                                          cache_dtype=jnp.float32, **kw),
            port_serving.PagedDecodeEngine(pp, pcfg, device="cpu",
                                           cache_dtype=torch.float32, **kw))
    got = []
    with torch.inference_mode():
        for eng, mod in zip(engs, (jax_serving, port_serving)):
            eng.prefill(0, list(range(10, 18)))
            free = eng.pool.num_free
            with pytest.raises(mod.PoolExhausted) as e:
                eng.prefill(1, list(range(20, 28)))
            assert eng.pool.num_free == free and eng.check_invariants()
            with pytest.raises(ValueError) as v:
                mod.ContinuousBatchingScheduler(eng, eos_id=1).submit(
                    mod.Request(prompt=(1, 2, 3), max_new_tokens=12))
            eng.free_slot(0)
            eng.pool.alloc = lambda: None          # a pool that never gives
            sched = mod.ContinuousBatchingScheduler(eng, eos_id=1)
            sched.submit(mod.Request(prompt=(1, 2, 3), max_new_tokens=2))
            with pytest.raises(mod.PoolExhausted) as s:
                sched.run()
            got.append((str(e.value), e.value.need, e.value.free,
                        e.value.cached, str(v.value), str(s.value),
                        s.value.need))
    assert got[0] == got[1]
    assert "pages" in got[0][4]


def test_kv8_teacher_forced_within_envelope(jax_params):
    """The int8 pool under fp32 weights: every teacher-forced decode
    logit within the JAX package's KV8_MAX_ABS of the fp32 full forward,
    and above 1e-5 (the int8 path ran)."""
    cfg, pcfg = _cfgs(True)
    pp = _port(jax_params[True])
    seq = torch.from_numpy(np.random.RandomState(1).randint(
        0, cfg.vocab_size, size=(1, 16))).long()
    prompt = 8
    eng = port_serving.PagedDecodeEngine(
        pp, pcfg, num_slots=2, max_len=32, num_pages=14, page_size=8,
        buckets=(8, 16, 32), cache_dtype=torch.int8, device="cpu")
    with torch.inference_mode():
        rows = [eng.prefill(0, seq[0, :prompt].tolist())[0]]
        for t in range(prompt, seq.shape[1]):
            assert eng.prepare_decode({0: t}) == []
            rows.append(eng.decode([int(seq[0, t]), 0], [True, False])[0])
        hidden = port_gpt.apply_gpt_unsharded(pp, pcfg, seq)
        want = torch.matmul(hidden, pp["embedding"]["word"][
            "embedding"].t())[0, prompt - 1:]
    err = float((torch.stack(rows) - want).abs().max())
    assert 1e-5 < err < KV8_MAX_ABS, err


def test_engine_checks_match_jax(jax_params):
    """Buckets off the page size and an int8 dense cache are refused
    with the reference's messages."""
    cfg, pcfg = _cfgs(False)
    jp = jax_params[False]
    pp = _port(jp)
    msgs = []
    for mod, p, c, dev in ((jax_serving, jp, cfg, {}),
                           (port_serving, pp, pcfg, {"device": "cpu"})):
        with pytest.raises(ValueError) as e:
            mod.PagedDecodeEngine(p, c, num_slots=1, max_len=32,
                                  num_pages=10, page_size=4,
                                  buckets=(6, 32), **dev)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]

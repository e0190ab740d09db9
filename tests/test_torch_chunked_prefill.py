"""Port parity for chunked prefill (``ContinuousBatchingScheduler(
chunk_tokens=...)`` on ``DecodeEngine`` and ``PagedDecodeEngine``)
against the JAX package on the CPU: the chunked cases of
``tests/L0/run_serving/test_scheduler.py`` on ``gpt_tiny`` with RoPE and
an fp32 cache (max_len 32, page size 4), the params carried across by
``params_from_jax``, each held to the JAX scheduler on the same
requests.

- The chunk attentions: the dense one against the JAX
  ``_chunk_prefill_attention`` and the paged one (through
  ``paged_chunk_attention``, whose plain version runs on the CPU)
  against the JAX ``_paged_chunk_prefill_attention``, fp32 within 1e-5,
  the written cache rows equal; on the card's dispatch a bf16 chunk
  takes the chunk kernel and an fp32 one the verify kernel, once a
  layer; ``chunk_limit`` covers ``paged_limit``.
- The port's chunked streams equal the JAX chunked scheduler's token for
  token (dense and paged, ``chunk_tokens`` 4 and 8, every tick token
  budget, with speculation, prefix sharing mid-chunk, a preempted
  request resumed through chunks, a host-tier promotion at
  ``begin_chunk_prefill``) and the port's own monolithic streams; the
  outcomes' tick fields equal the JAX ones.
- ``check_invariants`` holds between chunks (the parked row audited as
  empty). The final chunk's logits are a one-shot prefill's bit for bit
  on an fp32 cache, on both engines: the contract of the JAX test
  ``test_chunked_final_logits_match_one_shot_paged``.
- The reference's refusals, with its messages; and on the long-context
  Poisson mix of ``bench.py::_chunked_vs_monolithic_ab_pair`` (its
  arrivals from ``_scenario_arrivals``, driven by its ``_drive_poisson``)
  the streams and ``latency_summary()`` equal the JAX ones key for key,
  the chunked tail below the monolithic one.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from apex_tpu import serving as jax_serving
from apex_tpu.models import gpt as jax_gpt
from apex_tpu_torch import serving as port_serving
from apex_tpu_torch.models import gpt as port_gpt
from apex_tpu_torch.serving.cache import SCRATCH_PAGE

EOS = 0
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


def _chunky(cls):
    """The JAX test's mix: prompts that chunk_tokens 4 and 8 really
    split, a shared-prefix pair, greedy and sampled."""
    base = (7, 11, 13, 17, 19, 23, 29, 31, 37, 41, 43, 47)
    return [cls(prompt=base, max_new_tokens=5),
            cls(prompt=base[:9], max_new_tokens=5, temperature=0.8, seed=3),
            cls(prompt=base + (53, 59, 61), max_new_tokens=4),
            cls(prompt=(5, 3), max_new_tokens=5, temperature=0.7, seed=9)]


def _motif(cls):
    return [cls(prompt=(7, 11) * 5, max_new_tokens=6),
            cls(prompt=(5, 3) * 4, max_new_tokens=6, temperature=0.8,
                seed=3)]


def _port_engine(model, paged, num_pages=24, num_slots=2, **kw):
    _, _, cfg, params = model
    if paged:
        return port_serving.PagedDecodeEngine(
            params, cfg, num_slots=num_slots, max_len=MAX_LEN,
            num_pages=num_pages, page_size=4, buckets=(16, 32),
            cache_dtype=torch.float32, device="cpu", **kw)
    return port_serving.DecodeEngine(
        params, cfg, num_slots=num_slots, max_len=MAX_LEN,
        cache_dtype=torch.float32, device="cpu", **kw)


def _port_run(model, reqs, chunk, paged=False, budget=None, eos=EOS,
              **kw):
    """Drain ``reqs`` (port Requests) on a new engine (traced), auditing
    the pool after every tick; returns (streams, scheduler)."""
    eng = _port_engine(model, paged, tracer=port_serving.Tracer(), **kw)
    sched = port_serving.ContinuousBatchingScheduler(
        eng, eos_id=eos, chunk_tokens=chunk, tick_token_budget=budget)
    for r in reqs:
        sched.submit(r)
    with torch.inference_mode():
        while sched.busy:
            sched.step()
            assert eng.check_invariants()
    return sched.run(), sched


def _jax_run(model, reqs, chunk, paged=False, budget=None, eos=EOS,
             num_pages=24, num_slots=2, **kw):
    cfg, params, _, _ = model
    if paged:
        eng = jax_serving.PagedDecodeEngine(
            params, cfg, num_slots=num_slots, max_len=MAX_LEN,
            num_pages=num_pages, page_size=4, buckets=(16, 32),
            cache_dtype=jnp.float32, tracer=jax_serving.Tracer(), **kw)
    else:
        eng = jax_serving.DecodeEngine(params, cfg, num_slots=num_slots,
                                       max_len=MAX_LEN,
                                       cache_dtype=jnp.float32,
                                       tracer=jax_serving.Tracer(), **kw)
    sched = jax_serving.ContinuousBatchingScheduler(
        eng, eos_id=eos, audit=paged, chunk_tokens=chunk,
        tick_token_budget=budget)
    for r in reqs:
        sched.submit(r)
    return sched.run(), sched


def _ticks(sched):
    return [(o.tokens, o.reason, o.ttft_ticks, o.total_ticks,
             o.prefill_ticks) for _, o in sorted(sched.outcomes.items())]


def _same_run(sched, jsched):
    """Two drained schedulers agree on everything but the streams: the
    outcomes' tick fields, the counters and the tracers' tick-clock
    event streams and registries."""
    assert _ticks(sched) == _ticks(jsched)
    assert sched.stats.as_dict() == jsched.stats.as_dict()
    assert sched.tracer.tick_stream() == jsched.tracer.tick_stream()
    assert sched.tracer.registry.to_prometheus() \
        == jsched.tracer.registry.to_prometheus()


# -- the chunk attentions -----------------------------------------------------

def _chunk_inputs(model, sc, pos, n_real, seed):
    jcfg, _, _, _ = model
    rng = np.random.RandomState(seed)
    h = jcfg.hidden_size
    qkv = rng.randn(1, sc, 3 * h).astype(np.float32)
    mask = (np.arange(sc) < n_real).astype(np.int32)[None]
    return qkv, mask


@pytest.mark.parametrize("pos,n_real", [(0, 8), (16, 5)])
def test_dense_chunk_attention_matches_jax(model, pos, n_real):
    """The dense chunk attention (plain PyTorch) against the JAX
    function on a cache holding earlier rows: ctx within fp32 1e-5, the
    chunk's rows written at ``pos`` (pad rows zero), other rows and
    slots untouched."""
    jcfg, _, pcfg, _ = model
    sc, slots, nh, hd = 8, 2, jcfg.num_heads, jcfg.head_dim
    qkv, mask = _chunk_inputs(model, sc, pos, n_real, pos + n_real)
    rng = np.random.RandomState(1)
    kc = rng.randn(slots, nh, MAX_LEN, hd).astype(np.float32)
    vc = rng.randn(slots, nh, MAX_LEN, hd).astype(np.float32)
    ctx_j, kj, vj = jax.jit(jax_gpt._chunk_prefill_attention,
                            static_argnums=5)(
        jnp.asarray(qkv), jnp.asarray(kc), jnp.asarray(vc), jnp.int32(1),
        jnp.int32(pos), jcfg, jax_gpt._rope_or_none(jcfg, MAX_LEN),
        jnp.asarray(mask))
    kp, vp = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    ctx_p = port_gpt._chunk_prefill_attention(
        torch.from_numpy(qkv), kp, vp, 1, torch.tensor(pos, dtype=torch.int32),
        pcfg, port_gpt._rope_or_none(pcfg, MAX_LEN, "cpu"),
        torch.from_numpy(mask))
    np.testing.assert_allclose(ctx_p.numpy(), np.asarray(ctx_j), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(kp.numpy(), np.asarray(kj), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(vp.numpy(), np.asarray(vj), rtol=1e-5,
                               atol=1e-5)
    assert np.array_equal(kp.numpy()[0], kc[0])


@pytest.mark.parametrize("pos,n_real", [(0, 8), (16, 5)])
def test_paged_chunk_attention_matches_jax(model, pos, n_real):
    """The paged chunk attention against the JAX function: the chunk's
    page tiles written to ``write_pages`` (a shared page redirected to
    scratch), the attention through a gather row whose pages are
    scattered over the pool; ctx within fp32 1e-5, the pool's written
    pages equal."""
    jcfg, _, pcfg, _ = model
    sc, nh, hd, page, num_pages = 8, jcfg.num_heads, jcfg.head_dim, 4, 14
    qkv, mask = _chunk_inputs(model, sc, pos, n_real, 3 + pos)
    rng = np.random.RandomState(2)
    kpool = rng.randn(num_pages, nh, page, hd).astype(np.float32)
    vpool = rng.randn(num_pages, nh, page, hd).astype(np.float32)
    row = np.asarray([9, 4, 12, 6, 3, 11, 0, 0], np.int32)
    first = pos // page
    write = np.asarray([row[first + j] if first + j > 0 else SCRATCH_PAGE
                        for j in range(sc // page)], np.int32)
    ctx_j, kj, vj = jax.jit(jax_gpt._paged_chunk_prefill_attention,
                            static_argnums=6)(
        jnp.asarray(qkv), jnp.asarray(kpool), jnp.asarray(vpool),
        jnp.asarray(write), jnp.asarray(row), jnp.int32(pos), jcfg,
        jax_gpt._rope_or_none(jcfg, row.size * page), jnp.asarray(mask))
    kp, vp = torch.from_numpy(kpool.copy()), torch.from_numpy(vpool.copy())
    ctx_p = port_gpt._paged_chunk_prefill_attention(
        torch.from_numpy(qkv), kp, vp, torch.from_numpy(write),
        torch.from_numpy(row), torch.tensor(pos, dtype=torch.int32), pcfg,
        port_gpt._rope_or_none(pcfg, row.size * page, "cpu"),
        torch.from_numpy(mask))
    np.testing.assert_allclose(ctx_p.numpy(), np.asarray(ctx_j), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(kp.numpy(), np.asarray(kj), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(vp.numpy(), np.asarray(vj), rtol=1e-5,
                               atol=1e-5)


def _chunk_routes(model, monkeypatch, cache_dtype):
    """Drive a 13-token prompt through a paged engine's chunks of 8 with
    the card's dispatch in ``paged_attention`` (the launches replaced by
    their plain versions): the params in the pool's dtype, so q is too.
    Returns, per chunk, the model's ``paged_chunk_attention`` calls
    (shape, gather row, pos) and the kernel routes taken, and checks the
    parked stored row and the audit between chunks."""
    from apex_tpu_torch.transformer.functional import paged_attention as pa
    from apex_tpu_torch.utils.tree import tree_map

    _, _, cfg, params = model
    calls, routes = [], []
    real = port_gpt.paged_chunk_attention

    def spy(q, k_pages, v_pages, gather_row, pos, *a, **kw):
        calls.append((tuple(q.shape), gather_row.tolist(), pos.tolist()))
        return real(q, k_pages, v_pages, gather_row, pos, *a, **kw)

    def kernel(*a, **kw):
        routes.append("chunk")
        return pa.paged_chunk_attention_plain(*a, **kw)

    def verify(q, k_pages, v_pages, block_tables, pos, anc=None, **kw):
        routes.append(("verify", anc))
        return pa.paged_verify_attention_plain(q, k_pages, v_pages,
                                               block_tables, pos, anc, **kw)

    monkeypatch.setattr(port_gpt, "paged_chunk_attention", spy)
    monkeypatch.setattr(pa, "on_card", lambda t, what="": True)
    monkeypatch.setattr(pa, "paged_chunk_attention_kernel", kernel)
    monkeypatch.setattr(pa, "paged_verify_attention", verify)
    params = tree_map(lambda t: t.to(cache_dtype), params)
    eng = port_serving.PagedDecodeEngine(
        params, cfg, num_slots=2, max_len=MAX_LEN, num_pages=24,
        page_size=4, buckets=(16, 32), cache_dtype=cache_dtype,
        device="cpu")
    prompt = tuple(range(2, 15))                     # 13 tokens, 4 pages
    state = eng.begin_chunk_prefill(1, prompt)
    out = []
    with torch.inference_mode():
        for pos in range(0, 13, 8):
            calls.clear()
            routes.clear()
            final = pos + 8 >= len(prompt)
            eng.chunk_prefill(1, prompt[pos:pos + 8], pos, state, 8, final)
            out.append((pos, list(calls), list(routes)))
            stored = eng.cache.block_tables[1].tolist()
            assert stored == (state["row"].tolist() if final
                              else [SCRATCH_PAGE] * eng.max_pages)
            assert eng.check_invariants()
    return out, [state["row"].tolist()]


def test_paged_chunk_attends_through_the_verify_wrapper(model, monkeypatch):
    """An fp32 pool's chunk goes through ``paged_verify_attention`` on
    the card: every layer calls ``paged_chunk_attention`` once, over the
    slot's real gather row at the chunk's position, and it launches the
    verify kernel's route (a linear window of k1 = the chunk), never the
    chunk kernel — while the stored row stays parked on scratch until
    the final chunk installs it."""
    L, nh, hd = model[2].num_layers, model[2].num_heads, model[2].head_dim
    chunks, row = _chunk_routes(model, monkeypatch, torch.float32)
    for pos, calls, routes in chunks:
        assert calls == [((1, nh, 8, hd), row, [pos])] * L
        assert routes == [("verify", None)] * L


def test_paged_chunk_attends_through_the_chunk_wrapper(model, monkeypatch):
    """A bf16 chunk over a bf16 pool goes to the chunk kernel on the
    card: every layer calls ``paged_chunk_attention`` once, over the
    slot's real gather row at the chunk's position, and it launches the
    chunk kernel once, never the verify kernel."""
    L, nh, hd = model[2].num_layers, model[2].num_heads, model[2].head_dim
    chunks, row = _chunk_routes(model, monkeypatch, torch.bfloat16)
    for pos, calls, routes in chunks:
        assert calls == [((1, nh, 8, hd), row, [pos])] * L
        assert routes == ["chunk"] * L


@pytest.mark.parametrize("sc,pos,page,hd", [(8, 4, 4, 16), (64, 40, 24, 48)])
def test_chunk_limit_covers_paged_limit(sc, pos, page, hd):
    """``chunk_limit`` is finite, positive and at least ``paged_limit``
    on the same bf16 chunk (the tensor-core terms add to it); the plain
    chunk is the plain linear verify over the gather row."""
    from apex_tpu_torch.transformer.functional import paged_attention as pa

    rng = np.random.RandomState(sc + pos)
    nh, max_pages = 2, -(-(pos + sc) // page) + 1
    num_pages = 2 + max_pages
    k, v = (torch.from_numpy(rng.randn(num_pages, nh, page, hd).astype(
        np.float32)).to(torch.bfloat16) for _ in range(2))
    q = torch.from_numpy(rng.randn(1, nh, sc, hd).astype(
        np.float32)).to(torch.bfloat16)
    row = torch.from_numpy((2 + rng.permutation(max_pages)).astype(
        np.int32))[None]
    p = torch.tensor([pos], dtype=torch.int32)
    ctx = pa.paged_chunk_attention(q, k, v, row, p)
    assert torch.equal(ctx, pa.paged_verify_attention_plain(q, k, v, row, p))
    lim = pa.chunk_limit(q, k, v, row, p, ctx)
    assert lim.shape == ctx.shape
    assert bool(torch.isfinite(lim).all()) and bool((lim > 0).all())
    assert bool((lim >= pa.paged_limit(q, k, v, row, p, ctx)).all())


# -- streams against the JAX scheduler ----------------------------------------

@pytest.fixture(scope="module")
def jax_runs(model):
    """JAX chunked runs, each run once for the module."""
    runs = {}

    def get(name, reqs, chunk, **kw):
        if name not in runs:
            runs[name] = _jax_run(model, reqs(jax_serving.Request), chunk,
                                  **kw)
        return runs[name]

    return get


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("chunk", [4, 8])
def test_chunked_streams_match_jax_and_monolithic(model, jax_runs, paged,
                                                  chunk):
    """Chunked streams: the JAX chunked scheduler's token for token, with
    its outcomes' TTFT, total and prefill ticks, its counters and its
    tick-clock event stream; and the port's monolithic streams (chunking
    moves when prompt work runs, never what commits). The prompts really
    were split."""
    reqs = _chunky(port_serving.Request)
    got, sched = _port_run(model, reqs, chunk, paged)
    want, jsched = jax_runs(f"chunky_{paged}_{chunk}", _chunky, chunk,
                            paged=paged)
    assert got == want
    _same_run(sched, jsched)
    assert sched.stats.prefill_chunks > len(reqs)
    assert all(o.prefill_ticks >= 1 for o in sched.outcomes.values())
    assert got == _port_run(model, reqs, None, paged)[0]


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_chunked_streams_invariant_to_tick_token_budget(model, jax_runs,
                                                        paged):
    """The budget only sets how many chunks share a tick: a budget of 1
    (one chunk a tick), the default and 64 (whole prompts a tick) commit
    the same tokens, the JAX default's."""
    reqs = _chunky(port_serving.Request)
    want = jax_runs(f"chunky_{paged}_4", _chunky, 4, paged=paged)[0]
    for budget in (1, None, 64):
        got, sched = _port_run(model, reqs, 4, paged, budget=budget)
        assert got == want, budget
        assert sched.tick_token_budget == (budget or 2 + 4)


def test_chunked_spec_streams_match_plain_sync(model, jax_runs):
    """Chunked prefill composes with speculative decoding (linear, and
    tree on the port): the streams equal the plain monolithic
    scheduler's and the JAX chunked speculating one's, and speculation
    really ran."""
    reqs = _motif(port_serving.Request)
    plain = _port_run(model, reqs, None, True)[0]
    got, sched = _port_run(model, reqs, 4, True, spec_k=3)
    want, jsched = jax_runs("motif_spec", _motif, 4, paged=True, spec_k=3)
    assert got == want == plain
    _same_run(sched, jsched)
    assert sched.stats.prefill_chunks > len(reqs)
    assert sched.stats.tokens_drafted > 0 and sched.stats.spec_ticks > 0
    tree, tsched = _port_run(model, reqs, 4, True, spec_k=3, tree_spec=True)
    assert tree == plain and tsched.stats.spec_ticks > 0


def _shared(cls):
    """Three prompts on one 12-token (three-page) prefix; with two slots
    the third is admitted after the first finished and registered it."""
    prefix = tuple(range(40, 52))
    return [cls(prompt=prefix + (3, 5, 7), max_new_tokens=3),
            cls(prompt=prefix + (9,), max_new_tokens=8, temperature=0.8,
                seed=1),
            cls(prompt=prefix + (11, 13, 17, 19, 23), max_new_tokens=4)]


def test_prefix_sharing_mid_chunk(model, jax_runs, monkeypatch):
    """A chunked admission that shares cached prefix pages skips them
    (its first chunk starts past them, off the chunk grid, and a chunk
    touching a shared page writes it to scratch; the pool audited
    between ticks); the streams equal the monolithic port's and the JAX
    chunked scheduler's."""
    states = []
    begin = port_serving.PagedDecodeEngine.begin_chunk_prefill

    def spy(self, slot, prompt):
        st = begin(self, slot, prompt)
        states.append(dict(shared=st["shared"], start=st["start"]))
        return st

    monkeypatch.setattr(port_serving.PagedDecodeEngine,
                        "begin_chunk_prefill", spy)
    reqs = _shared(port_serving.Request)
    got, sched = _port_run(model, reqs, 8, True)
    want, jsched = jax_runs("shared", _shared, 8, paged=True)
    assert got == want == _port_run(model, reqs, None, True)[0]
    _same_run(sched, jsched)
    # the third prompt's five pages: three shared, so its chunks start at
    # the last shared page's end, 12 (the last page always runs)
    assert {"shared": 3, "start": 12} in states, states


def _tight(cls):
    return [cls(prompt=(5, 6, 7, 8, 9), max_new_tokens=8),
            cls(prompt=(9, 8, 7, 6, 5), max_new_tokens=8, temperature=0.9,
                seed=2)]


def test_preempted_request_resumes_through_chunks(model, jax_runs):
    """On a pool of 7 pages two 5-token prompts x 8 new tokens preempt;
    the preempted request is requeued and re-admitted through chunks (its
    prompt plus the tokens it had, the first token not sampled again),
    and the streams equal a roomy pool's and the JAX scheduler's on the
    same tight pool."""
    reqs = _tight(port_serving.Request)
    roomy = _port_run(model, reqs, None, True, eos=-1)[0]
    got, sched = _port_run(model, reqs, 4, True, eos=-1, num_pages=7)
    want, jsched = jax_runs("tight", _tight, 4, paged=True, eos=-1,
                            num_pages=7)
    assert sched.stats.preemptions > 0
    assert got == want == roomy
    _same_run(sched, jsched)


def _churn(cls):
    hot = tuple(range(7, 15))
    cold = [tuple(range(100 * k + 1, 100 * k + 9)) for k in (1, 2, 3)]
    return ([cls(prompt=hot, max_new_tokens=4)]
            + [cls(prompt=p, max_new_tokens=4) for p in cold]
            + [cls(prompt=hot, max_new_tokens=4, temperature=1.0, seed=3)])


def test_host_tier_promote_at_begin_chunk_prefill(model, jax_runs):
    """With a host tier on a 10-page pool, the hot prefix spills and a
    chunked re-admission promotes it in ``begin_chunk_prefill`` (charged
    on the next chunk's clock); the streams equal a tier-less chunked
    engine's, and the outcomes' ticks and counters the JAX run's."""
    reqs = _churn(port_serving.Request)
    bare = _port_run(model, reqs, 8, True, eos=-1, num_pages=10)[0]
    got, sched = _port_run(model, reqs, 8, True, eos=-1, num_pages=10,
                           host_tier=port_serving.PrefixRegistry(1 << 20))
    want, jsched = jax_runs("churn", _churn, 8, paged=True, eos=-1,
                            num_pages=10,
                            host_tier=jax_serving.PrefixRegistry(1 << 20))
    st = sched.stats
    assert st.host_spills > 0 and st.host_promotes > 0
    assert got == want == bare
    _same_run(sched, jsched)


# -- engine level: invariants between chunks, final logits --------------------

def _chunks(eng, slot, prompt, ct):
    """Drive one prompt chunk by chunk, auditing between chunks; returns
    the final chunk's logits."""
    state = eng.begin_chunk_prefill(slot, prompt)
    pos = int(state.get("start", 0))
    while True:
        final = pos + ct >= len(prompt)
        logits = eng.chunk_prefill(slot, prompt[pos:pos + ct], pos, state,
                                   ct, final)
        assert eng.check_invariants()
        if eng.paged and not final:
            assert eng.cache.block_tables[slot].tolist() \
                == [SCRATCH_PAGE] * eng.max_pages
        if final:
            eng.finish_chunk_prefill(slot, state)
            return logits, state
        pos += ct


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_final_chunk_logits_match_one_shot(model, paged):
    """The final chunk's last-token logits are BITWISE a one-shot
    prefill's on an fp32 cache (the JAX test's contract), for the same
    13-token prompt in four chunks of 4; then a second prompt sharing
    two cached pages, chunked from past them, against its own one-shot
    prefill."""
    prompt = tuple(range(2, 15))
    with torch.inference_mode():
        one_shot = _port_engine(model, paged).prefill(0, prompt)
        eng = _port_engine(model, paged)
        logits, _ = _chunks(eng, 0, prompt, 4)
        assert torch.equal(logits, one_shot)
        assert int(eng.cache.lengths[0]) == len(prompt)
        if not paged:
            return
        other = prompt[:8] + (40, 41, 42)
        want = _port_engine(model, True).prefill(0, other)
        got, state = _chunks(eng, 1, other, 4)
        assert (state["shared"], state["start"]) == (2, 8)
        assert eng._slot_pages[1][:2] == eng._slot_pages[0][:2]
        assert torch.equal(got, want)


def test_free_slot_mid_chunk_releases_its_pages(model):
    """A slot freed between chunks releases every staged page and leaves
    the parked set; the audit holds after."""
    eng = _port_engine(model, True)
    free0 = eng.pool.num_free
    prompt = tuple(range(2, 15))
    state = eng.begin_chunk_prefill(0, prompt)
    with torch.inference_mode():
        eng.chunk_prefill(0, prompt[:4], 0, state, 4, False)
    assert eng.check_invariants() and 0 in eng._prefill_parked
    eng.free_slot(0)
    assert eng.check_invariants() and not eng._prefill_parked
    assert eng.pool.num_free == free0


# -- configuration ------------------------------------------------------------

def test_chunk_config_validation(model):
    """``chunk_tokens`` must be >= 1, divide max_len and be page-aligned
    on a paged engine, and is refused over the int8 pool; the tick token
    budget must be positive — each refusal the reference's ValueError
    with its message."""
    jcfg, jp, _, _ = model

    def jax_eng(paged, dtype=jnp.bfloat16):
        if paged:
            return jax_serving.PagedDecodeEngine(
                jp, jcfg, num_slots=1, max_len=MAX_LEN, num_pages=8,
                page_size=4, buckets=(16, 32), cache_dtype=dtype)
        return jax_serving.DecodeEngine(jp, jcfg, num_slots=1,
                                        max_len=MAX_LEN)

    def port_eng(paged, dtype=torch.bfloat16):
        _, _, cfg, params = model
        if paged:
            return port_serving.PagedDecodeEngine(
                params, cfg, num_slots=1, max_len=MAX_LEN, num_pages=8,
                page_size=4, buckets=(16, 32), cache_dtype=dtype,
                device="cpu")
        return port_serving.DecodeEngine(params, cfg, num_slots=1,
                                         max_len=MAX_LEN, device="cpu")

    cases = [(False, None, dict(chunk_tokens=0), ">= 1"),
             (False, None, dict(chunk_tokens=5), "divide"),
             (True, None, dict(chunk_tokens=2), "page_size"),
             (True, "int8", dict(chunk_tokens=4), "int8"),
             (False, None, dict(chunk_tokens=4, tick_token_budget=0),
              "tick_token_budget")]
    for paged, dt, kw, match in cases:
        pe = port_eng(paged, torch.int8) if dt else port_eng(paged)
        je = jax_eng(paged, jnp.int8) if dt else jax_eng(paged)
        with pytest.raises(ValueError, match=match) as got:
            port_serving.ContinuousBatchingScheduler(pe, eos_id=EOS, **kw)
        with pytest.raises(ValueError) as want:
            jax_serving.ContinuousBatchingScheduler(je, eos_id=EOS, **kw)
        assert str(got.value) == str(want.value)
    sched = port_serving.ContinuousBatchingScheduler(port_eng(False),
                                                     eos_id=EOS,
                                                     chunk_tokens=8)
    assert (sched.chunk_tokens, sched.tick_token_budget) == (8, 1 + 8)
    assert port_serving.ContinuousBatchingScheduler(
        port_eng(True), eos_id=EOS).tick_token_budget is None


# -- the long-context Poisson A/B ---------------------------------------------

def test_poisson_ab_latency_summary_matches_jax(model):
    """``bench.py::_chunked_vs_monolithic_ab_pair``'s sides (the module's
    gpt_tiny with RoPE, the pair's own seed and config, a bf16 page pool of 48 pages of 4, 2 slots, chunk 8 against
    monolithic) on its long-context arrivals, open-loop through
    ``bench._drive_poisson`` (``at_tick`` backdating on the work clock):
    each side's streams and ``latency_summary()`` equal the JAX side's
    key for key (ticks are exact), the outcomes' tick fields too; the
    chunked streams equal the monolithic ones, the chunked ITL tail is
    below the monolithic one and the TTFT median within the JAX bound
    (2x monolithic + 1)."""
    jcfg, jp, pcfg, pp = model
    arrivals = bench._scenario_arrivals("long_context", jcfg.vocab_size)
    port_arrivals = [(t, port_serving.Request(
        prompt=r.prompt, max_new_tokens=r.max_new_tokens,
        temperature=r.temperature, seed=r.seed)) for t, r in arrivals]
    assert max(len(r.prompt) for _, r in arrivals) >= 40

    def side(serving, params, cfg, arr, chunk, **kw):
        trc = serving.Tracer()
        eng = serving.PagedDecodeEngine(params, cfg, num_slots=2,
                                        max_len=64, num_pages=48,
                                        page_size=4, buckets=(16, 64),
                                        tracer=trc, **kw)
        sched = serving.ContinuousBatchingScheduler(eng, eos_id=-1,
                                                    chunk_tokens=chunk)
        streams = bench._drive_poisson(sched, arr)
        return streams, trc.latency_summary(), _ticks(sched)

    res = {}
    for chunk in (8, None):
        with torch.inference_mode():
            port = side(port_serving, pp, pcfg, port_arrivals, chunk,
                        device="cpu")
        want = side(jax_serving, jp, jcfg, arrivals, chunk)
        assert port == want, chunk
        res[chunk] = port
    (s_c, lat_c, _), (s_m, lat_m, _) = res[8], res[None]
    assert s_c == s_m
    assert lat_c["itl_p99"] < lat_m["itl_p99"]
    assert lat_c["ttft_p50"] <= 2.0 * lat_m["ttft_p50"] + 1.0

"""Port parity for speculative decoding: ``apex_tpu_torch``'s drafters,
accept rules, verify steps and the speculating scheduler against the
JAX package's on ``gpt_tiny`` with RoPE (and ``draft_gpt_tiny``-sized
drafts where the reference's tests allow it), the JAX parameters carried
across by ``params_from_jax``. The port runs on the CPU (the plain
versions of its kernels); the JAX side runs as its own serving tests run
it.

Host code (``ngram_draft``, ``tree_arrays``, the accept walks) is held
equal exactly. A verify step's logits are held to the JAX step's within
1e-5 and its caches alike: fp32 rows within 1e-5 (the two frameworks'
projections round otherwise), a bf16 pool within one bf16 rounding, an
int8 pool's pages exactly and its scales within fp32 rounding; on the
same projected rows the int8 verify write gives the JAX pages and
scales bit for bit. Scheduler streams are held equal
to the JAX scheduler's integer for integer, with its counters, and to
the port's own ``spec_k=0`` streams, in every mode: n-gram, model, tree
and adaptive drafts; dense and paged caches; fp32, bf16 and int8 pools;
weight-only int8 params; greedy and seeded sampling."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import serving as jax_serving
from apex_tpu.models import gpt as jax_gpt
from apex_tpu.quant import kernels as jax_quant
from apex_tpu.quant import quantize_params as jax_quantize_params
from apex_tpu_torch import serving as port_serving
from apex_tpu_torch.models import gpt as port_gpt
from apex_tpu_torch.quant import quantize_params as port_quantize_params
from apex_tpu_torch.serving.cache import RESERVED_PAGES, SCRATCH_PAGE
from apex_tpu_torch.transformer.functional import paged_attention as pa

EOS = 0
MAX_LEN = 32
BUCKETS = (16, 32)


def _cfgs():
    return (dataclasses.replace(jax_gpt.gpt_tiny(), use_rope=True,
                                hidden_dropout=0.0),
            dataclasses.replace(port_gpt.gpt_tiny(), use_rope=True,
                                hidden_dropout=0.0))


@pytest.fixture(scope="module")
def params():
    cfg, _ = _cfgs()
    jp = jax_gpt.init_gpt(jax.random.PRNGKey(0), cfg)
    return jp, _port(jp)


def _port(tree):
    return port_gpt.params_from_jax(jax.tree.map(np.asarray, tree), "cpu")


def _t(x):
    """numpy -> torch, bf16 through a uint16 view."""
    x = np.asarray(x)
    if x.dtype.name == "bfloat16":
        return torch.from_numpy(x.view(np.uint16).astype(np.int32)).to(
            torch.int16).view(torch.bfloat16)
    return torch.from_numpy(x.copy())


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


# -- host code: drafts, grids, accept walks ----------------------------------

def _histories():
    rng = np.random.RandomState(0)
    out = [[], [4], [1, 2, 3, 1, 2], [7, 7, 7, 7], [5, 9, 5, 9, 5]]
    for _ in range(60):
        n = rng.randint(1, 40)
        out.append([int(t) for t in rng.randint(0, 6, size=n)])
    return out


def test_ngram_draft_matches_jax():
    for h in _histories():
        for k in (0, 1, 3, 7):
            for lo, hi in ((1, 3), (2, 2), (1, 1)):
                got = port_serving.ngram_draft(h, k, max_ngram=hi,
                                               min_ngram=lo)
                assert got == jax_serving.ngram_draft(
                    h, k, max_ngram=hi, min_ngram=lo), (h, k, lo, hi)
    assert port_serving.ngram_draft([1, 2, 3, 1, 2], 3) == [3, 1, 2]


def _random_trees(rng, b, k1):
    forced, trees = [], []
    for _ in range(b):
        f = rng.randint(1, k1 + 1)
        forced.append([int(t) for t in rng.randint(0, 50, size=f)])
        n = rng.randint(0, k1 - f + 1)
        if n == 0:
            trees.append(None)
            continue
        pars = [int(rng.randint(-1, i)) for i in range(n)]
        trees.append(([int(t) for t in rng.randint(0, 50, size=n)], pars))
    return forced, trees


def test_tree_arrays_match_jax():
    rng = np.random.RandomState(1)
    for k1 in (1, 2, 5, 9):
        forced, trees = _random_trees(rng, 6, k1)
        got = port_serving.tree_arrays(forced, trees, k1)
        want = jax_serving.tree_arrays(forced, trees, k1)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError, match="exceeds grid width"):
        port_serving.tree_arrays([[1, 2]], [([3, 4], [-1, 0])], 3)


def test_speculative_accept_matches_jax():
    rng = np.random.RandomState(2)
    for k in (1, 3, 5):
        tokens = rng.randint(0, 3, size=(16, k + 1)).astype(np.int32)
        drafts = rng.randint(0, 3, size=(16, k)).astype(np.int32)
        lens = rng.randint(0, k + 1, size=(16,)).astype(np.int32)
        got = port_serving.speculative_accept(
            torch.from_numpy(tokens), torch.from_numpy(drafts),
            torch.from_numpy(lens))
        want = jax_serving.speculative_accept(
            jnp.asarray(tokens), jnp.asarray(drafts), jnp.asarray(lens))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_tree_speculative_accept_matches_jax():
    rng = np.random.RandomState(3)
    for k1 in (1, 3, 6, 9):
        forced, trees = _random_trees(rng, 8, k1)
        tok, dep, anc, val, par, start = port_serving.tree_arrays(
            forced, trees, k1)
        # samples that follow some branches: copy children's tokens
        samples = rng.randint(0, 50, size=tok.shape).astype(np.int32)
        for b in range(tok.shape[0]):
            for j in range(k1):
                kids = [c for c in range(k1) if val[b, c] and par[b, c] == j]
                if kids and rng.rand() < 0.7:
                    samples[b, j] = tok[b, kids[rng.randint(len(kids))]]
        got = port_serving.tree_speculative_accept(
            *(torch.from_numpy(x) for x in (samples, tok, par, val, start)))
        want = jax_serving.tree_speculative_accept(
            *(jnp.asarray(x) for x in (samples, tok, par, val, start)))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# -- the multi-query attention's plain version --------------------------------

def _window_case(tree, seed=0):
    """gpt_tiny heads with RoPE; q_k_v for k1 = 4 columns, pools whose
    pages the block tables scatter, the per-slot lengths and (for trees)
    depth and ancestor matrices from ``tree_arrays``."""
    rng = np.random.RandomState(seed)
    cfg, _ = _cfgs()
    nh, hd, k1, page, mp = cfg.num_heads, cfg.head_dim, 4, 4, 5
    pos = np.asarray([0, 3, 5, 12], np.int32)
    b, num_pages = len(pos), 24
    qkv = rng.randn(b, k1, 3 * nh * hd).astype(np.float32)
    k = rng.randn(num_pages, nh, page, hd).astype(np.float32)
    v = rng.randn(num_pages, nh, page, hd).astype(np.float32)
    ids = rng.permutation(np.arange(RESERVED_PAGES, num_pages))
    bt = np.full((b, mp), SCRATCH_PAGE, np.int32)
    for i, p in enumerate(pos):
        n = (p + k1 - 1) // page + 1
        bt[i, :n] = ids[mp * i:mp * i + n]
    forced = [[1], [1, 2], [1], [1, 2, 3]]
    trees = [([4, 5, 6], [-1, 0, -1]), ([7, 8], [-1, -1]),
             ([9, 10, 11], [-1, 0, 1]), None]
    _, depth, anc, *_ = jax_serving.tree_arrays(forced, trees, k1)
    if not tree:
        depth = np.tile(np.arange(k1, dtype=np.int32), (b, 1))
        anc = None
    return cfg, qkv, k, v, bt, pos, depth, anc


@pytest.mark.parametrize("case", ["linear", "tree", "int8"])
def test_paged_verify_attention_matches_jax(case):
    """The port's paged verify attention (writes, then the plain
    multi-query attention) against JAX's ``_paged_verify_attention`` /
    ``_paged_tree_verify_attention`` / ``_paged_verify_attention_q8``:
    ctx within fp32 rounding, the written fp32 pools within it, the int8
    pages and scales (rescale at column 0, pinned scales past it, dead
    rows zeroed) bit for bit."""
    tree = case == "tree"
    cfg, qkv, k, v, bt, pos, depth, anc = _window_case(tree)
    mp, page = bt.shape[1], k.shape[2]
    freqs = jax_gpt._rope_or_none(cfg, mp * page)
    if case == "int8":
        rng = np.random.RandomState(7)
        kq, ks = jax_quant.kv_quantize(jnp.asarray(k))
        vq, vs = jax_quant.kv_quantize(jnp.asarray(v * rng.rand()))
        want = jax_gpt._paged_verify_attention_q8(
            jnp.asarray(qkv), kq, vq, ks, vs, jnp.asarray(bt),
            jnp.asarray(pos), cfg, freqs)
        _, pcfg = _cfgs()
        pfreqs = port_gpt._rope_or_none(pcfg, mp * page, "cpu")
        pools = [_t(x) for x in (kq, vq, ks, vs)]
        ctx = port_gpt._paged_verify_attention(
            _t(qkv), pools[0], pools[1], _t(bt), _t(pos), pcfg, pfreqs,
            pools[2], pools[3])
        np.testing.assert_allclose(_f32(ctx), _f32(want[0]), rtol=1e-5,
                                   atol=1e-5)
        for got, w in zip(pools, want[1:]):
            np.testing.assert_array_equal(got.numpy(), np.asarray(w))
        return
    if tree:
        want = jax_gpt._paged_tree_verify_attention(
            jnp.asarray(qkv), jnp.asarray(k), jnp.asarray(v),
            jnp.asarray(bt), jnp.asarray(pos), jnp.asarray(depth),
            jnp.asarray(anc), cfg, freqs)
    else:
        want = jax_gpt._paged_verify_attention(
            jnp.asarray(qkv), jnp.asarray(k), jnp.asarray(v),
            jnp.asarray(bt), jnp.asarray(pos), cfg, freqs)
    _, pcfg = _cfgs()
    pfreqs = port_gpt._rope_or_none(pcfg, mp * page, "cpu")
    pk, pv = _t(k), _t(v)
    if tree:
        ctx = port_gpt._paged_tree_verify_attention(
            _t(qkv), pk, pv, _t(bt), _t(pos), _t(depth), _t(anc), pcfg,
            pfreqs)
    else:
        ctx = port_gpt._paged_verify_attention(
            _t(qkv), pk, pv, _t(bt), _t(pos), pcfg, pfreqs)
    np.testing.assert_allclose(_f32(ctx), _f32(want[0]), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(pk.numpy(), np.asarray(want[1]), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(pv.numpy(), np.asarray(want[2]), rtol=1e-6,
                               atol=1e-6)


def test_verify_plain_linear_is_the_tree_form_with_a_chain():
    """The linear mask is the tree mask with anc[i, j] = i <= j; column j
    of a linear verify equals the decode plain version at pos + j when
    the window's rows are the same; the limit is positive and finite."""
    cfg, qkv, k, v, bt, pos, depth, _ = _window_case(False, seed=4)
    nh, hd = cfg.num_heads, cfg.head_dim
    b, k1 = qkv.shape[:2]
    q = _t(qkv[..., :nh * hd].reshape(b, k1, nh, hd).transpose(0, 2, 1, 3)
           .copy())
    pk, pv, pbt, ppos = _t(k), _t(v), _t(bt), _t(pos)
    chain = torch.from_numpy(np.tile(np.triu(np.ones((k1, k1), bool)),
                                     (b, 1, 1)))
    lin = pa.paged_verify_attention(q, pk, pv, pbt, ppos)
    assert torch.equal(lin, pa.paged_verify_attention(q, pk, pv, pbt, ppos,
                                                      chain))
    for j in range(k1):
        dec = pa.paged_decode_attention(q[:, :, j].contiguous(), pk, pv,
                                        pbt, ppos + j)
        np.testing.assert_allclose(lin[:, :, j].numpy(), dec.numpy(),
                                   rtol=1e-6, atol=1e-6)
    lim = pa.paged_limit(q, pk, pv, pbt, ppos, lin)
    assert lim.shape == lin.shape and bool((lim > 0).all())
    assert bool(torch.isfinite(lim).all())
    with pytest.raises(ValueError, match="anc must be bool"):
        pa.paged_verify_attention(q, pk, pv, pbt, ppos, chain.int())


@pytest.mark.parametrize("tree", [False, True], ids=["linear", "tree"])
def test_verify_wrapper_slices_past_max_k1(monkeypatch, tree):
    """k1 = 80 at hd 64: on the card path ``paged_verify_attention``
    launches once a slice of ``verify_slices`` ((0, 64) and (64, 16)),
    each slice writing its queries of the window, and the slices'
    plain versions put together equal one plain call over the window
    within ``paged_limit`` (the kernel is stood in for by its plain
    version of the same slice)."""
    rng = np.random.RandomState(9)
    b, nh, hd, page, mp, k1 = 3, 2, 64, 8, 24, 80
    pos = torch.tensor([0, 7, 112], dtype=torch.int32)
    pk = torch.from_numpy(rng.randn(2 + b * mp, nh, page, hd)
                          .astype(np.float32))
    pv = torch.from_numpy(rng.randn(*pk.shape).astype(np.float32))
    bt = torch.from_numpy(2 + rng.permutation(b * mp).reshape(b, mp)
                          .astype(np.int32))
    q = torch.from_numpy(rng.randn(b, nh, k1, hd).astype(np.float32))
    anc = None
    if tree:
        forced, trees = [], []
        for _ in range(b):
            f = rng.randint(1, k1 + 1)
            forced.append([1] * f)
            n = k1 - f
            trees.append(([2] * n, [int(rng.randint(-1, i))
                                    for i in range(n)]) if n else None)
        anc = torch.from_numpy(port_serving.tree_arrays(forced, trees,
                                                        k1)[2])
    calls = []

    def kernel(q, k, v, bt, pos, anc, ks, vs, scale, q0, nq, out):
        calls.append((q0, nq))
        out[:, :, q0:q0 + nq] = pa.paged_verify_attention_plain(
            q, k, v, bt, pos, anc, ks, vs, scale, q0=q0, nq=nq)
        return out

    monkeypatch.setattr(pa, "on_card", lambda t, what="tensor": True)
    monkeypatch.setattr(pa, "paged_verify_attention_kernel", kernel)
    got = pa.paged_verify_attention(q, pk, pv, bt, pos, anc)
    assert calls == pa.verify_slices(k1, hd) == [(0, 64), (64, 16)]
    want = pa.paged_verify_attention_plain(q, pk, pv, bt, pos, anc)
    lim = pa.paged_limit(q, pk, pv, bt, pos, want, anc=anc)
    assert bool(((got - want).abs() <= lim).all())
    assert pa.verify_slices(5, hd) == [(0, 5)]
    assert pa.verify_slices(100, 128) == [(0, 64), (64, 36)]


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_wide_verify_past_a_free_slots_position_table(paged):
    """Learned positions (a 64-row table, max_len 64) at spec_k 24 (k1
    25): once the 50-token request finishes, its free slot's stale
    length plus the window passes the table while the other slot
    speculates. The JAX engine reads those rows as ``jnp.take``'s fill
    (NaN, in a row nobody commits); the port reads them the same way and
    serves the JAX scheduler's streams, which equal its spec_k=0
    streams."""
    jcfg = dataclasses.replace(jax_gpt.gpt_tiny(), hidden_dropout=0.0)
    pcfg = dataclasses.replace(port_gpt.gpt_tiny(), hidden_dropout=0.0)
    jp = jax_gpt.init_gpt(jax.random.PRNGKey(1), jcfg)
    rng = np.random.RandomState(2)
    reqs = [dict(prompt=tuple(int(t) for t in rng.randint(1, 512, 50)),
                 max_new_tokens=4),
            dict(prompt=(7, 11, 13, 7, 11, 13, 7, 11, 13, 7),
                 max_new_tokens=24)]

    def run(mod, params, cfg, spec_k, **extra):
        if paged:
            extra.update(num_pages=40, page_size=4)
        eng = (mod.PagedDecodeEngine if paged else mod.DecodeEngine)(
            params, cfg, num_slots=2, max_len=64, buckets=(32, 64),
            spec_k=spec_k, **extra)
        sched = mod.ContinuousBatchingScheduler(eng, eos_id=EOS)
        for r in reqs:
            sched.submit(mod.Request(**r))
        with torch.inference_mode():
            out = sched.run()
        return out, sched

    want, jsched = run(jax_serving, jp, jcfg, 24)
    got, psched = run(port_serving, _port(jp), pcfg, 24, device="cpu")
    plain, _ = run(port_serving, _port(jp), pcfg, 0, device="cpu")
    assert got == want == plain
    assert psched.stats.spec_ticks == jsched.stats.spec_ticks > 0


# -- verify steps --------------------------------------------------------------

PROMPTS = ((7, 11, 7, 11, 7), (5, 3, 5, 3, 9, 2))
GRID = ((7, 11, 7, 11), (2, 5, 3, 5))


def _verify_engines(params, kind, dtype, w8=False):
    jcfg, pcfg = _cfgs()
    jp, pp = params
    if w8:
        jp, pp = jax_quantize_params(jp), port_quantize_params(pp)
    tree = kind.startswith("tree")
    kw = dict(num_slots=2, max_len=MAX_LEN, buckets=BUCKETS, spec_k=3,
              tree_spec=tree)
    if kind.endswith("paged"):
        kw.update(num_pages=24, page_size=4)
        jeng = jax_serving.PagedDecodeEngine(
            jp, jcfg, cache_dtype=getattr(jnp, dtype), **kw)
        peng = port_serving.PagedDecodeEngine(
            pp, pcfg, cache_dtype=getattr(torch, dtype), device="cpu", **kw)
    else:
        jeng = jax_serving.DecodeEngine(jp, jcfg,
                                        cache_dtype=getattr(jnp, dtype),
                                        **kw)
        peng = port_serving.DecodeEngine(pp, pcfg,
                                         cache_dtype=getattr(torch, dtype),
                                         device="cpu", **kw)
    return jeng, peng


def _assert_cache_equal(pc, jc, dtype):
    for name in ("k", "v", "k_scale", "v_scale", "lengths",
                 "block_tables"):
        got, want = getattr(pc, name, None), getattr(jc, name, None)
        if want is None:
            assert got is None
            continue
        if name in ("k_scale", "v_scale"):
            # amax / 127 of rows the two frameworks project with other
            # roundings: within fp32 rounding (bit for bit on the same
            # rows: test_paged_verify_attention_matches_jax[int8])
            np.testing.assert_allclose(_f32(got), _f32(want), rtol=2e-6,
                                       atol=0)
        elif dtype == "bfloat16" and name in ("k", "v"):
            np.testing.assert_allclose(_f32(got), _f32(want), rtol=2 ** -7,
                                       atol=1e-6)
        elif name in ("k", "v") and dtype == "float32":
            np.testing.assert_allclose(_f32(got), _f32(want), rtol=1e-5,
                                       atol=1e-5)
        else:
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


VERIFY_CASES = {  # name -> (kind, pool dtype, w8)
    "dense_f32": ("dense", "float32", False),
    "paged_f32": ("paged", "float32", False),
    "paged_bf16": ("paged", "bfloat16", False),
    "paged_int8": ("paged", "int8", False),
    "paged_w8": ("paged", "float32", True),
    "tree_dense": ("tree_dense", "float32", False),
    "tree_paged": ("tree_paged", "float32", False),
}


@pytest.mark.parametrize("case", sorted(VERIFY_CASES))
def test_verify_fn_matches_jax(params, case):
    """Two prompts prefilled, a page boundary crossed by the window,
    then one verify (or tree verify) step on each side: logits within
    1e-5, caches alike (int8 pages and scales exactly), lengths not
    advanced."""
    kind, dtype, w8 = VERIFY_CASES[case]
    jeng, peng = _verify_engines(params, kind, dtype, w8)
    positions = {i: len(p) for i, p in enumerate(PROMPTS)}
    with torch.inference_mode():
        for i, p in enumerate(PROMPTS):
            jeng.prefill(i, p)
            peng.prefill(i, p)
        jeng.prepare_decode(positions, n_new=4)
        peng.prepare_decode(positions, n_new=4)
        if kind.startswith("tree"):
            forced = [[7], [2, 5]]
            trees = [([11, 3, 7], [-1, -1, 0]), ([3, 8], [-1, -1])]
            tok, dep, anc, *_ = jax_serving.tree_arrays(forced, trees, 4)
            want = jeng.tree_verify(jnp.asarray(tok), jnp.asarray(dep),
                                    jnp.asarray(anc))
            got = peng.tree_verify(tok, dep, anc)
        else:
            want = jeng.verify(jnp.asarray(GRID, jnp.int32))
            got = peng.verify(GRID)
    assert got.shape == (2, 4, port_gpt.gpt_tiny().vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    _assert_cache_equal(peng.cache, jeng.cache, dtype)
    assert peng.cache.lengths.tolist() == [len(p) for p in PROMPTS]
    peng.commit([2, 1])
    assert peng.cache.lengths.tolist() == [len(PROMPTS[0]) + 2,
                                           len(PROMPTS[1]) + 1]


def test_paged_tree_verify_refuses_int8(params):
    _, pcfg = _cfgs()
    with pytest.raises(ValueError, match="int8"):
        port_serving.PagedDecodeEngine(
            params[1], pcfg, num_slots=1, max_len=MAX_LEN, num_pages=24,
            page_size=4, spec_k=2, tree_spec=True, cache_dtype=torch.int8,
            device="cpu")
    eng = port_serving.PagedDecodeEngine(
        params[1], pcfg, num_slots=1, max_len=MAX_LEN, num_pages=24,
        page_size=4, buckets=BUCKETS, cache_dtype=torch.int8, device="cpu")
    fn = port_serving.make_paged_tree_verify_fn(pcfg)
    with pytest.raises(ValueError, match="int8 page pool"):
        fn(params[1], eng.cache, torch.zeros((1, 2), dtype=torch.int64),
           torch.zeros((1, 2), dtype=torch.int64),
           torch.ones((1, 2, 2), dtype=torch.bool))


# -- scheduler streams ---------------------------------------------------------

def _spec_requests(req):
    # repetitive prompts give the n-gram drafter traction; the sampled
    # requests pin the fold_in(seed, n_generated + j) key alignment
    return [req(prompt=(7, 11, 7, 11, 7), max_new_tokens=8),
            req(prompt=(5, 3, 5, 3), max_new_tokens=8, temperature=0.8,
                seed=3),
            req(prompt=(7, 11, 7, 11), max_new_tokens=6, temperature=0.7,
                seed=9),
            req(prompt=(13, 17, 19), max_new_tokens=5)]


def _engine(mod, params, cfg, paged, dtype, **kw):
    if kw.get("draft_model") == "self":
        kw["draft_model"] = mod.DraftModel(params, cfg, num_slots=2,
                                           max_len=MAX_LEN,
                                           **({} if mod is jax_serving
                                              else {"device": "cpu"}))
    dt = getattr(jnp if mod is jax_serving else torch, dtype)
    extra = {} if mod is jax_serving else {"device": "cpu"}
    if paged:
        return mod.PagedDecodeEngine(params, cfg, num_slots=2,
                                     max_len=MAX_LEN, num_pages=24,
                                     page_size=4, buckets=BUCKETS,
                                     cache_dtype=dt, **kw, **extra)
    return mod.DecodeEngine(params, cfg, num_slots=2, max_len=MAX_LEN,
                            buckets=BUCKETS, cache_dtype=dt, **kw, **extra)


def _port_run(params, paged, dtype, reqs=None, **kw):
    _, pcfg = _cfgs()
    eng = _engine(port_serving, params, pcfg, paged, dtype, **kw)
    sched = port_serving.ContinuousBatchingScheduler(eng, eos_id=EOS)
    for r in reqs or _spec_requests(port_serving.Request):
        sched.submit(r if isinstance(r, port_serving.Request)
                     else port_serving.Request(**r))
    with torch.inference_mode():
        while sched.busy:
            sched.step()
            assert eng.check_invariants()
    return sched.run(), sched


def _jax_run(params, paged, dtype, reqs=None, **kw):
    jcfg, _ = _cfgs()
    eng = _engine(jax_serving, params, jcfg, paged, dtype, **kw)
    sched = jax_serving.ContinuousBatchingScheduler(eng, eos_id=EOS,
                                                    audit=paged)
    for r in reqs or _spec_requests(jax_serving.Request):
        sched.submit(r if isinstance(r, jax_serving.Request)
                     else jax_serving.Request(**r))
    return sched.run(), sched


def _counters(sched):
    st = sched.stats
    return (st.spec_ticks, st.plain_ticks, st.tokens_drafted,
            st.tokens_accepted)


def _jax_counters(sched):
    st = sched.stats
    return (st.spec_ticks, st.plain_ticks, st.tokens_drafted,
            st.tokens_accepted)


STREAM_CASES = {  # name -> (paged, pool dtype, w8, engine kwargs)
    "ngram_dense": (False, "float32", False, dict(spec_k=3)),
    "ngram_paged_bf16": (True, "bfloat16", False, dict(spec_k=2)),
    "ngram_paged_int8": (True, "int8", False, dict(spec_k=3)),
    "ngram_paged_w8": (True, "float32", True, dict(spec_k=2)),
    "model_paged": (True, "float32", False,
                    dict(spec_k=3, draft_model="self")),
    "tree_paged": (True, "float32", False,
                   dict(spec_k=3, draft_model="self", tree_spec=True)),
    "tree_dense_ngram": (False, "float32", False,
                         dict(spec_k=3, tree_spec=True)),
    "adaptive_paged": (True, "float32", False,
                       dict(spec_k=4, draft_model="self",
                            adaptive_spec=True)),
}


@pytest.mark.parametrize("case", sorted(STREAM_CASES))
def test_spec_streams_match_jax_and_plain(params, case):
    """The speculating scheduler commits the JAX scheduler's streams
    integer for integer, with its spec/plain tick and draft/accept
    counters and its outcomes' tick accounting, and its own spec_k=0
    streams; the drafter proposed, and every tick's pool audit holds."""
    paged, dtype, w8, kw = STREAM_CASES[case]
    jp, pp = params
    if w8:
        jp, pp = jax_quantize_params(jp), port_quantize_params(pp)
    want, jsched = _jax_run(jp, paged, dtype, **kw)
    got, psched = _port_run(pp, paged, dtype, **kw)
    plain, _ = _port_run(pp, paged, dtype)
    assert got == want
    assert got == plain
    assert _counters(psched) == _jax_counters(jsched)
    assert psched.stats.tokens_drafted > 0
    for rid in range(len(got)):
        o, w = psched.outcomes[rid], jsched.outcomes[rid]
        assert (o.reason, o.ttft_ticks, o.total_ticks) == (
            w.reason, w.ttft_ticks, w.total_ticks)
    if "model" in case or "tree" in case:
        assert psched.stats.tokens_accepted > 0
        assert 0 < psched.stats.acceptance_rate <= 1


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("spec_k", [1, 2, 3])
def test_spec_stream_bit_identical_to_plain(params, spec_k, paged):
    """(tests/L0/run_serving/test_scheduler.py) greedy and seeded-sampled
    requests through draft, verify and accept: the committed streams
    equal the spec_k=0 streams at every depth, on both layouts, on the
    reference's bf16 cache."""
    plain, _ = _port_run(params[1], paged, "bfloat16")
    spec, sched = _port_run(params[1], paged, "bfloat16", spec_k=spec_k)
    assert spec == plain
    assert sched.stats.tokens_drafted > 0 and sched.stats.tokens_accepted >= 0


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_tree_spec_stream_bit_identical_to_plain(params, paged):
    """(test_scheduler.py) tree speculation with the target as its own
    drafter: streams equal plain decode, and the tree path commits
    accepted tokens."""
    plain, _ = _port_run(params[1], paged, "bfloat16")
    spec, sched = _port_run(params[1], paged, "bfloat16", spec_k=3,
                            draft_model="self", tree_spec=True)
    assert spec == plain
    assert sched.stats.spec_ticks > 0 and sched.stats.tokens_accepted > 0


def test_spec_near_max_len_degrades_to_plain(params):
    """(test_scheduler.py) a slot within spec_k + 1 rows of max_len
    runs plain ticks; the stream matches the plain run and the JAX
    engine's."""
    jcfg, pcfg = _cfgs()

    def run(mod, p, cfg, spec_k):
        extra = {} if mod is jax_serving else {"device": "cpu"}
        eng = mod.PagedDecodeEngine(p, cfg, num_slots=1, max_len=16,
                                    num_pages=24, page_size=4,
                                    buckets=(8, 16), spec_k=spec_k, **extra)
        sched = mod.ContinuousBatchingScheduler(eng, eos_id=EOS)
        sched.submit(mod.Request(prompt=(7, 11, 7, 11, 7),
                                 max_new_tokens=8))
        with torch.inference_mode():
            return sched.run(), sched

    got, psched = run(port_serving, params[1], pcfg, 3)
    assert got == run(port_serving, params[1], pcfg, 0)[0]
    want, jsched = run(jax_serving, params[0], jcfg, 3)
    assert got == want
    assert psched.stats.plain_ticks == jsched.stats.plain_ticks > 0


def test_spec_config_validation(params):
    """(test_scheduler.py) draft_model / tree_spec / adaptive_spec need
    spec_k >= 1; the draft net must match the slots and vocabulary; the
    tensor-parallel drafter is A4.5."""
    _, pcfg = _cfgs()
    pp = params[1]
    kw = dict(num_slots=1, max_len=MAX_LEN, device="cpu")
    for bad in (dict(tree_spec=True), dict(adaptive_spec=True)):
        with pytest.raises(ValueError, match="spec_k"):
            port_serving.DecodeEngine(pp, pcfg, **kw, **bad)
    dm = port_serving.DraftModel(pp, pcfg, num_slots=1, max_len=MAX_LEN,
                                 device="cpu")
    with pytest.raises(ValueError, match="slots"):
        port_serving.DecodeEngine(pp, pcfg, num_slots=2, max_len=MAX_LEN,
                                  spec_k=2, draft_model=dm, device="cpu")
    other = dataclasses.replace(pcfg, vocab_size=pcfg.vocab_size + 1)
    dm.cfg = other
    with pytest.raises(ValueError, match="vocabulary"):
        port_serving.DecodeEngine(pp, pcfg, spec_k=2, draft_model=dm, **kw)
    with pytest.raises(NotImplementedError, match="A4.5"):
        port_serving.DraftModel(pp, pcfg, num_slots=1, max_len=MAX_LEN,
                                model=object(), device="cpu")
    with pytest.raises(ValueError, match="chunk"):
        port_serving.DraftModel(pp, pcfg, num_slots=1, max_len=MAX_LEN,
                                chunk=0, device="cpu")


def test_spec_stream_w8_bit_identical_to_plain(params):
    """(test_quant.py) speculation under int8 weights commits the plain
    quantized streams on both layouts, greedy and seeded."""
    pp = port_quantize_params(params[1])
    reqs = [dict(prompt=(7, 11, 7, 11, 7), max_new_tokens=6),
            dict(prompt=(5, 3, 5, 3), max_new_tokens=6, temperature=0.8,
                 seed=3),
            dict(prompt=(13, 17, 19), max_new_tokens=4)]
    for paged in (False, True):
        plain, _ = _port_run(pp, paged, "float32", reqs)
        spec, sched = _port_run(pp, paged, "float32", reqs, spec_k=2)
        assert spec == plain and sched.stats.tokens_drafted > 0


def test_kv8_rejected_tails_do_not_perturb(params):
    """(test_quant.py) two runs whose first verify carried different
    garbage draft tails give bit-identical later verify and decode
    logits on the int8 pool (column 0 rescales, the tail keeps the
    scale, dead rows are zeroed) — and the JAX engine's int8 pages and
    scales."""
    _, pcfg = _cfgs()
    jcfg, _ = _cfgs()
    k, pl = 3, 6
    seq = [7, 11, 13, 2, 5, 9, 4, 8, 6, 3, 12, 1]

    def run(mod, p, cfg, garbage):
        extra = {} if mod is jax_serving else {"device": "cpu"}
        eng = mod.PagedDecodeEngine(p, cfg, num_slots=1, max_len=MAX_LEN,
                                    num_pages=14, page_size=4,
                                    cache_dtype=(jnp if mod is jax_serving
                                                 else torch).int8,
                                    buckets=(8, 16), spec_k=k, **extra)
        eng.prefill(0, seq[:pl])
        eng.prepare_decode({0: pl}, n_new=k + 1)
        bad = [[seq[pl]] + [garbage] * k]
        eng.verify(jnp.asarray(bad, jnp.int32) if mod is jax_serving
                   else bad)
        eng.commit([1])
        eng.prepare_decode({0: pl + 1}, n_new=k + 1)
        good = [seq[pl + 1:pl + k + 2]]
        lv = eng.verify(jnp.asarray(good, jnp.int32) if mod is jax_serving
                        else good)
        eng.commit([1])
        eng.prepare_decode({0: pl + 2})
        if mod is jax_serving:
            lp = eng.decode(jnp.asarray([seq[pl + 2]], jnp.int32),
                            jnp.asarray([True]))
        else:
            lp = eng.decode([seq[pl + 2]], [True])
        return _f32(lv), _f32(lp), eng.cache

    with torch.inference_mode():
        va, pa_, ca = run(port_serving, params[1], pcfg, 3)
        vb, pb, _ = run(port_serving, params[1], pcfg, 499)
    np.testing.assert_array_equal(va, vb)
    np.testing.assert_array_equal(pa_, pb)
    vj, pj, cj = run(jax_serving, params[0], jcfg, 3)
    np.testing.assert_allclose(va, vj, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(pa_, pj, rtol=1e-5, atol=1e-5)
    _assert_cache_equal(ca, cj, "int8")


# -- the model drafter (tests/L0/run_serving/test_draft.py) -------------------

def _greedy_reference(pp, cfg, history, k):
    """k greedy continuations of ``history`` by the port's full
    forward."""
    toks, out = list(history), []
    table = pp["embedding"]["word"]["embedding"]
    for _ in range(k):
        h = port_gpt.apply_gpt_unsharded(pp, cfg, torch.tensor([toks]))
        nxt = int(torch.argmax(torch.matmul(h[0, -1], table.t())))
        out.append(nxt)
        toks.append(nxt)
    return out


def _drafters(params):
    jcfg, pcfg = _cfgs()
    return (jax_serving.DraftModel(params[0], jcfg, num_slots=2,
                                   max_len=MAX_LEN),
            port_serving.DraftModel(params[1], pcfg, num_slots=2,
                                    max_len=MAX_LEN, device="cpu"))


def test_draft_model_matches_jax_and_greedy_reference(params):
    """Linear drafts equal the JAX drafter's and the full forward's
    greedy continuations; after a partial accept the resync rolls back
    to the common prefix; a freed slot forgets its rows."""
    _, pcfg = _cfgs()
    jdm, pdm = _drafters(params)
    h0, h1 = [5, 9, 3, 7], [11, 13, 2]
    with torch.inference_mode():
        got = pdm.draft([h0, h1], [3, 2])
        assert got == jdm.draft([h0, h1], [3, 2])
        assert got[0] == _greedy_reference(params[1], pcfg, h0, 3)
        assert got[1] == _greedy_reference(params[1], pcfg, h1, 2)
        h2 = h0 + [got[0][0], (got[0][1] + 1) % pcfg.vocab_size]
        again = pdm.draft([h2, None], [3, 0])
        assert again == jdm.draft([h2, None], [3, 0])
        assert again[0] == _greedy_reference(params[1], pcfg, h2, 3)
        pdm.free_slot(0)
        jdm.free_slot(0)
        fresh = pdm.draft([[7, 11], None], [2, 0])
        assert fresh == jdm.draft([[7, 11], None], [2, 0])
        assert fresh[0] == _greedy_reference(params[1], pcfg, [7, 11], 2)


def test_draft_model_tree_matches_jax(params):
    """draft_tree: a greedy chain of k - 1 plus the second-best root
    child, as the JAX drafter gives it."""
    _, pcfg = _cfgs()
    jdm, pdm = _drafters(params)
    with torch.inference_mode():
        got = pdm.draft_tree([[5, 9, 3, 7], [2, 4]], [3, 1])
    assert got == jdm.draft_tree([[5, 9, 3, 7], [2, 4]], [3, 1])
    toks, parents = got[0]
    assert toks[:2] == _greedy_reference(params[1], pcfg, [5, 9, 3, 7], 2)
    assert parents == [-1, 0, -1] and toks[2] != toks[0]
    assert len(got[1][0]) == 1 and got[1][1] == [-1]

"""Port parity for the paged cache's host code and its attention: the
page allocator, prefix registry, quota ledger and spill wire format of
``apex_tpu_torch.serving.paging`` driven by one sequence of operations
beside the JAX package's, the int8 KV codecs bit for bit, and the paged
decode attention (bf16/fp32 and int8 pools, RoPE, permuted block
tables) against the JAX functions on ``gpt_tiny``'s heads. The port
runs on the CPU (the plain version of its paged attention kernel).

Tolerances: the codecs, the host state and the allocator's decisions
exactly; ctx against JAX fp32 1e-5, bf16 one bf16 ulp plus 1e-5 (the
frameworks round at the same places, their matrix products sum in other
orders); the port's ctx under two page placements bit for bit."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.models import gpt as jax_gpt
from apex_tpu.quant import kernels as jax_quant
from apex_tpu.serving import faults as jax_faults
from apex_tpu.serving import health as jax_health
from apex_tpu.serving import paging as jax_paging
from apex_tpu_torch.models import gpt as port_gpt
from apex_tpu_torch.quant import kernels as port_quant
from apex_tpu_torch.serving import health as port_health
from apex_tpu_torch.serving import paging as port_paging
from apex_tpu_torch.serving.cache import RESERVED_PAGES, SCRATCH_PAGE
from apex_tpu_torch.transformer.functional import paged_attention as pa


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
    return np.asarray(x).astype(np.float32)


# -- wire formats -------------------------------------------------------------

@pytest.mark.parametrize("tokens,page", [
    ([1, 2, 3, 4, 5, 6, 7], 4), ([0], 4), (list(range(8)), 2),
    (list(range(100, 137)), 8), ([2 ** 31 - 1, -5, 0], 2)])
def test_prefix_page_keys_match_jax(tokens, page):
    assert port_paging.prefix_page_keys(tokens, page) == \
        jax_paging.prefix_page_keys(tokens, page)
    assert port_paging.PAGE_KEY_VERSION == jax_paging.PAGE_KEY_VERSION


def test_spill_header_and_checksum_match_jax():
    assert port_paging.SPILL_DTYPE_TAGS == jax_paging.SPILL_DTYPE_TAGS
    assert port_paging.SPILL_HEADER_BYTES == jax_paging.SPILL_HEADER_BYTES
    key = port_paging.prefix_page_keys([3, 1, 4, 1, 5], 4)[-1]
    for geom in ((2, 2, 4, 8, 1), (24, 16, 64, 64, 4)):
        h = port_paging.encode_spill_header(key, *geom)
        assert h == jax_paging.encode_spill_header(key, *geom)
        assert port_paging.decode_spill_header(h) == \
            jax_paging.decode_spill_header(h)
    rng = np.random.RandomState(0)
    k = rng.randn(2, 1, 2, 4, 8).astype(np.float32)
    v = rng.randn(2, 1, 2, 4, 8).astype(np.float32)
    s = rng.rand(2, 1, 2).astype(np.float32)
    for args in ((h, k, v), (h, k, v, s, s + 1)):
        assert port_paging.spill_checksum(*args) == \
            jax_paging.spill_checksum(*args)
    for mod in (port_paging, jax_paging):
        with pytest.raises(ValueError, match="32-byte"):
            mod.encode_spill_header(b"short", 2, 2, 4, 8, 1)


# -- one sequence of operations on both sides ---------------------------------

def _pool_ops(mod, free_order):
    """Drive a pool (and its registry's LRU) through allocation,
    sharing, copy-on-write bookkeeping, eviction under pressure and
    exhaustion; returns the snapshots and stats after every step and
    the results of the calls."""
    pool = mod.PagePool(RESERVED_PAGES + 6, 4, free_order=free_order)
    log = []

    def note(*res):
        log.append((res, pool.snapshot(), pool.stats(),
                    pool.num_free, pool.num_cached, pool.occupancy))

    a = [pool.alloc() for _ in range(3)]
    note(a)
    ka = mod.prefix_page_keys([5, 6, 7, 8, 9, 10, 11, 12, 13, 14], 4)
    kb = mod.prefix_page_keys([5, 6, 7, 8, 1, 2, 3], 4)
    pool.register_prefix(ka, a)
    note()
    slots = [list(a), pool.match_prefix(kb)]
    note(slots[1], [pool.needs_copy(p) for p in a])
    pool.check_invariants(slots)
    b = [pool.alloc()]
    slots[1] += b
    note(b)
    pool.register_prefix(kb, slots[1])
    note(pool.refcount(slots[1][0]))
    pool.check_invariants(slots)
    for p in slots[0]:
        pool.release(p)
    slots[0] = []
    note()
    hit = pool.match_prefix(ka[:1])
    note(hit)
    pool.release(hit[0])
    more = [pool.alloc() for _ in range(5)]   # evicts the LRU entries
    note(more)
    note(pool.evict_prefix(kb[0]), pool.evict_prefix(b"\0" * 32))
    pool.check_invariants([[p for p in more if p is not None], slots[1]])
    for p in more:
        if p is not None:
            pool.release(p)
    note()
    return log


@pytest.mark.parametrize("free_order", [None, "reversed"])
def test_page_pool_matches_jax(free_order):
    order = None if free_order is None else list(
        reversed(range(RESERVED_PAGES, RESERVED_PAGES + 6)))
    assert _pool_ops(port_paging, order) == _pool_ops(jax_paging, order)


def test_pool_errors_match_jax():
    for mod in (port_paging, jax_paging):
        with pytest.raises(ValueError, match="permutation"):
            mod.PagePool(6, 4, free_order=[0, 1, 2, 3])
        with pytest.raises(ValueError, match="reserved"):
            mod.PagePool(RESERVED_PAGES, 4)
        pool = mod.PagePool(6, 4)
        with pytest.raises(ValueError, match="free/reserved"):
            pool.release(SCRATCH_PAGE)
    pools = [mod.PagePool(6, 4) for mod in (port_paging, jax_paging)]
    errs = []
    for pool, err in zip(pools, (port_health, jax_health)):
        p = pool.alloc()
        pool._ref[p] += 1            # a leaked reference
        with pytest.raises(err.PoolInvariantError) as e:
            pool.check_invariants([[p]])
        errs.append(str(e.value))
    assert errs[0] == errs[1]


def test_pool_injector_is_owed():
    """The injector the pool once owed (the fault tier): a fired
    ``pool_alloc`` draw refuses one allocation without sweeping the
    prefix registry, as the JAX pool's does."""
    from apex_tpu_torch.serving.faults import FaultInjector

    pools = [mod.PagePool(6, 4, injector=inj) for mod, inj in (
        (port_paging, FaultInjector(schedule={"pool_alloc": (1,)})),
        (jax_paging, jax_faults.FaultInjector(schedule={"pool_alloc": (1,)})))]
    for pool in pools:
        first = pool.alloc()
        pool.register_prefix([b"k"], [first])
        pool.release(first)
    got = [[pool.alloc() for _ in range(4)] + [pool.num_cached,
                                                pool.injector.counts]
           for pool in pools]
    assert got[0] == got[1]
    assert got[0][0] is None and got[0][4] == 1
    assert got[0][5]["pool_alloc"] == 1


def _record(mod, key, rng, quant):
    k = rng.randn(2, 1, 2, 4, 8).astype(np.float32)
    v = rng.randn(2, 1, 2, 4, 8).astype(np.float32)
    ks = vs = None
    if quant:
        ks, vs = rng.rand(2, 1, 2).astype(np.float32), rng.rand(
            2, 1, 2).astype(np.float32)
    h = mod.encode_spill_header(key, 2, 2, 4, 8, 4 if quant else 2)
    return mod.SpillRecord(h, k, v, ks, vs,
                           mod.spill_checksum(h, k, v, ks, vs))


def _registry_ops(mod):
    rng = np.random.RandomState(1)
    keys = mod.prefix_page_keys(list(range(40)), 4)
    recs = [_record(mod, k, rng, i % 2 == 1) for i, k in enumerate(keys)]
    reg = mod.PrefixRegistry(3 * recs[0].nbytes)
    log = [(reg.put(keys[i], recs[i]), reg.stats()) for i in range(3)]
    log.append((reg.get(keys[0]) is recs[0], reg.get(keys[5]), reg.stats()))
    log += [(reg.put(keys[i], recs[i]), reg.stats()) for i in (3, 0, 4)]
    log.append((reg.drop(keys[4]), reg.drop(keys[9]), len(reg),
                keys[0] in reg, reg.nbytes, reg.check_invariants()))
    big = mod.PrefixRegistry(10)
    log.append((big.put(keys[1], recs[1]), big.stats()))
    return log


def test_prefix_registry_matches_jax():
    got, want = _registry_ops(port_paging), _registry_ops(jax_paging)
    assert repr(got) == repr(want)


def _ledger_ops(mod, err):
    led = mod.QuotaLedger({"a": 4, "b": None})
    led.charge("a", 3)
    led.charge("b", 50)
    out = [led.can_charge("a", 1), led.can_charge("a", 2), led.snapshot()]
    with pytest.raises(err.QuotaExhausted) as e:
        led.charge("a", 2)
    out.append((str(e.value), e.value.payload))
    led.credit("a", 3)
    with pytest.raises(err.PoolInvariantError) as e:
        led.credit("a", 1)
    out += [str(e.value), led.check(), led.snapshot()]
    pool = mod.PagePool(6, 4)
    pool.ledger = led
    out.append(pool.snapshot())
    return out


def test_quota_ledger_matches_jax():
    assert _ledger_ops(port_paging, port_health) == \
        _ledger_ops(jax_paging, jax_health)


# -- int8 KV codecs -----------------------------------------------------------

def _codec_inputs():
    rng = np.random.RandomState(2)
    t = (rng.randn(3, 4, 8, 16) * rng.uniform(0.01, 10, (3, 4, 1, 1))
         ).astype(np.float32)
    t[1, 2] = 0.0                                   # an all-zero page
    # exact .5 ties at scale 1 (amax 127): round half to even
    tie = np.zeros((8, 16), np.float32)
    tie[0, 0] = 127.0
    tie[1, :8] = [0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -126.5]
    t[2, 1] = tie
    return t


def test_kv_quantize_bit_for_bit_with_jax():
    t = _codec_inputs()
    jq, js = jax_quant.kv_quantize(jnp.asarray(t))
    pq, ps = port_quant.kv_quantize(torch.from_numpy(t))
    assert pq.dtype == torch.int8 and ps.dtype == torch.float32
    np.testing.assert_array_equal(pq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ps.numpy().view(np.int32),
                                  np.asarray(js).view(np.int32))
    assert ps[1, 2] == 0 and not pq[1, 2].any()
    assert pq[2, 1, 1, :8].tolist() == [0, 2, 2, 0, -2, -2, 126, -126]
    jd = jax_quant.kv_dequantize(jq, js)
    pd = port_quant.kv_dequantize(pq, ps)
    np.testing.assert_array_equal(pd.numpy().view(np.int32),
                                  np.asarray(jd).view(np.int32))


def test_kv_quantize_bf16_tiles_match_jax():
    t = _codec_inputs().astype(jnp.bfloat16)
    jq, js = jax_quant.kv_quantize(jnp.asarray(t))
    pq, ps = port_quant.kv_quantize(_t(t))
    np.testing.assert_array_equal(pq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))


# -- paged decode attention ---------------------------------------------------

NUM_PAGES, PAGE, MAX_PAGES = 20, 4, 4
POS = (0, 3, 4, 13)     # first row, a page's last row, the next's first


def _attn_case(dtype, seed=0):
    """gpt_tiny heads (nh 8, hd 8) with RoPE; (q_k_v, pools, two block
    tables mapping the same logical rows to other physical pages)."""
    rng = np.random.RandomState(seed)
    cfg = dataclasses.replace(jax_gpt.gpt_tiny(), use_rope=True)
    nh, hd, b = cfg.num_heads, cfg.head_dim, len(POS)
    qkv = rng.randn(b, 1, 3 * nh * hd).astype(np.float32)
    k = rng.randn(NUM_PAGES, nh, PAGE, hd).astype(np.float32)
    v = rng.randn(NUM_PAGES, nh, PAGE, hd).astype(np.float32)
    ids = rng.permutation(np.arange(RESERVED_PAGES, NUM_PAGES))[:b * 4]
    bt = np.full((b, MAX_PAGES), SCRATCH_PAGE, np.int32)
    for i, p in enumerate(POS):
        n = p // PAGE + 1
        bt[i, :n] = ids[4 * i:4 * i + n]
    # the same logical rows on other physical pages
    perm = np.arange(NUM_PAGES)
    perm[RESERVED_PAGES:] = RESERVED_PAGES + rng.permutation(
        NUM_PAGES - RESERVED_PAGES)
    k2, v2 = np.empty_like(k), np.empty_like(v)
    k2[perm], v2[perm] = k, v
    bt2 = np.where(bt >= RESERVED_PAGES, perm[bt], bt).astype(np.int32)
    if dtype == "bf16":
        qkv, k, v, k2, v2 = (x.astype(jnp.bfloat16)
                             for x in (qkv, k, v, k2, v2))
    return cfg, qkv, (k, v, bt), (k2, v2, bt2), perm


def _port_cfg(cfg):
    return dataclasses.replace(port_gpt.gpt_tiny(), use_rope=cfg.use_rope)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_paged_decode_attention_matches_jax(dtype):
    cfg, qkv, (k, v, bt), (k2, v2, bt2), perm = _attn_case(dtype)
    pos = np.asarray(POS, np.int32)
    freqs = jax_gpt._rope_or_none(cfg, MAX_PAGES * PAGE)
    jctx, jk, jv = jax_gpt._paged_decode_attention(
        jnp.asarray(qkv), jnp.asarray(k), jnp.asarray(v), jnp.asarray(bt),
        jnp.asarray(pos), cfg, freqs)
    pcfg = _port_cfg(cfg)
    pfreqs = port_gpt._rope_or_none(pcfg, MAX_PAGES * PAGE, "cpu")
    outs = []
    for kk, vv, tt in ((k, v, bt), (k2, v2, bt2)):
        pk, pv = _t(kk), _t(vv)
        ctx = port_gpt._paged_decode_attention(
            _t(qkv), pk, pv, _t(tt), _t(pos), pcfg, pfreqs)
        outs.append((ctx, pk, pv))
    ctx, pk, pv = outs[0]
    tol = 1e-5 if dtype == "f32" else 2 ** -7
    np.testing.assert_allclose(_f32(ctx), _f32(jctx), rtol=tol, atol=1e-5)
    # the written rows: the same values (RoPE'd k in fp32 then cast)
    np.testing.assert_allclose(_f32(pk), _f32(jk), rtol=tol, atol=1e-6)
    np.testing.assert_allclose(_f32(pv), _f32(jv), rtol=tol, atol=1e-6)
    # placement: the same logical rows on other pages, the same bits
    assert torch.equal(outs[1][0], ctx)
    assert torch.equal(outs[1][1][perm], pk)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_paged_decode_attention_q8_matches_jax(dtype):
    cfg, qkv, (k, v, bt), (k2, v2, bt2), perm = _attn_case(dtype, seed=1)
    kq, ks = jax_quant.kv_quantize(jnp.asarray(k, jnp.float32))
    vq, vs = jax_quant.kv_quantize(jnp.asarray(v, jnp.float32))
    pos = np.asarray(POS, np.int32)
    freqs = jax_gpt._rope_or_none(cfg, MAX_PAGES * PAGE)
    want = jax_gpt._paged_decode_attention_q8(
        jnp.asarray(qkv), kq, vq, ks, vs, jnp.asarray(bt), jnp.asarray(pos),
        cfg, freqs)
    pcfg = _port_cfg(cfg)
    pfreqs = port_gpt._rope_or_none(pcfg, MAX_PAGES * PAGE, "cpu")
    outs = []
    for order, tt in ((np.arange(NUM_PAGES), bt), (perm, bt2)):
        pools = [torch.empty_like(_t(x)) for x in (kq, vq, ks, vs)]
        for dst, x in zip(pools, (kq, vq, ks, vs)):
            dst[order] = _t(x)
        ctx = port_gpt._paged_decode_attention(
            _t(qkv), pools[0], pools[1], _t(tt), _t(pos), pcfg, pfreqs,
            pools[2], pools[3])
        outs.append((ctx, [x[order] for x in pools]))
    ctx, pools = outs[0]
    tol = 1e-5 if dtype == "f32" else 2 ** -7
    np.testing.assert_allclose(_f32(ctx), _f32(want[0]), rtol=tol,
                               atol=1e-5)
    # the requantized pages and scales: int8 exactly, scales exactly
    # (the RMW of each written page sees the same fp32 rows)
    for got, w in zip(pools, want[1:]):
        np.testing.assert_array_equal(got.numpy(), np.asarray(w))
    assert torch.equal(outs[1][0], ctx)
    for a, b in zip(outs[1][1], pools):
        assert torch.equal(a, b)


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_plain_attention_skips_rows_past_pos(quant):
    """Rows past ``pos`` (stale rows, other slots' pages through the
    table, the scratch page) take no part: garbage written there leaves
    ctx's bits unchanged, and ``paged_limit`` is positive and finite."""
    rng = np.random.RandomState(3)
    b, nh, hd = 3, 2, 16
    q = torch.from_numpy(rng.randn(b, nh, hd).astype(np.float32)).to(
        torch.bfloat16)
    if quant:
        k = torch.from_numpy(rng.randint(-127, 128, (9, nh, PAGE, hd))
                             ).to(torch.int8)
        v = k.flip(0).clone()
        ks = torch.from_numpy(rng.rand(9, nh).astype(np.float32))
        vs = ks.flip(0).clone()
    else:
        k = torch.from_numpy(rng.randn(9, nh, PAGE, hd).astype(
            np.float32)).to(torch.bfloat16)
        v, ks, vs = k.flip(0).clone(), None, None
    bt = torch.tensor([[2, 3, 1], [4, 1, 1], [5, 6, 7]], dtype=torch.int32)
    pos = torch.tensor([5, 0, 11], dtype=torch.int32)
    ctx = pa.paged_decode_attention(q, k, v, bt, pos, ks, vs)
    assert ctx.dtype == q.dtype and ctx.shape == (b, nh, hd)
    k2, v2 = k.clone(), v.clone()
    for t in (k2, v2):
        t[3, :, 2:] = 100 if quant else 1e4   # past pos 5 in slot 0
        t[1] = 7                              # scratch
        t[4, :, 1:] = -9                      # past pos 0 in slot 1
    assert torch.equal(pa.paged_decode_attention(q, k2, v2, bt, pos, ks,
                                                 vs), ctx)
    lim = pa.paged_limit(q, k, v, bt, pos, ctx, ks, vs)
    assert lim.shape == ctx.shape and bool((lim > 0).all())
    assert bool(torch.isfinite(lim).all())


def test_paged_parts_and_work_buffer():
    """The decode and verify kernel's split, as the wrapper sizes it: a
    part a ``PART_ROWS`` (128) logical positions of the table, and a work
    record a (slot, head, part, query) of hd rounded up to 4 floats and
    m, l, none when the table fits one part; ``verify_slices`` steps
    ``MAX_K1``, 62 at hd 256 (an fp32 pool's shared memory), and refuses
    a head wider than the kernel takes."""
    assert pa.PART_ROWS == 128
    assert [pa.paged_parts(n) for n in (1, 127, 128, 129, 512, 1024)] == [
        1, 1, 1, 2, 4, 8]
    assert pa.paged_work_floats(8, 16, 1, 64, 128) == 0
    assert pa.paged_work_floats(8, 16, 1, 64, 1024) == 8 * 16 * 8 * 66
    assert pa.paged_work_floats(2, 4, 5, 6, 200) == 2 * 4 * 2 * 5 * 10
    assert pa.verify_slices(100, 128) == [(0, 64), (64, 36)]
    assert pa.verify_slices(100, 256) == [(0, 62), (62, 38)]
    assert pa.verify_slices(64, 6) == [(0, 64)]
    assert pa._smem(62, 256, 4) <= pa._MAX_SMEM < pa._smem(63, 256, 4)
    with pytest.raises(ValueError, match="head_dim up to 256"):
        pa.verify_slices(5, 257)


def test_split_buffers_are_cached_per_device():
    """The split kernels' work buffers and counters come from one cache
    a device: a request the newest buffer holds returns it, a larger one
    a new buffer of at least twice the size, and the older buffers stay
    referenced (a captured CUDA graph keeps valid pointers)."""
    store, dev = {}, torch.device("cpu", 0)
    made = []

    def make(n):
        made.append(n)
        return torch.zeros((n,), dtype=torch.int32)

    first = pa._cached(store, 10, dev, make)
    assert made == [1024] and pa._cached(store, 1024, dev, make) is first
    second = pa._cached(store, 1500, dev, make)
    assert made == [1024, 2048] and second.numel() == 2048
    assert store[0] == [first, second]
    assert pa._cached(store, 3, torch.device("cpu", 1), make) is not second
    assert sorted(store) == [0, 1]


@pytest.mark.parametrize("s_len", [128, 1024])
def test_paged_limit_adds_the_part_combine(s_len):
    """``paged_limit`` is the sequential walk's terms plus the parts'
    combine, (2 D + N + 4) u (A + |ctx|) with N = ``paged_parts(S)``:
    per element never below the walk's terms, and above them by that
    much."""
    rng = np.random.RandomState(11)
    b, nh, hd, page = 2, 2, 16, 16
    mp = s_len // page
    q = torch.from_numpy(rng.randn(b, nh, hd).astype(np.float32))
    k = torch.from_numpy(rng.randn(2 + b * mp, nh, page, hd).astype(
        np.float32))
    v = torch.from_numpy(rng.randn(*k.shape).astype(np.float32))
    bt = torch.from_numpy(2 + np.arange(b * mp, dtype=np.int32).reshape(
        b, mp))
    pos = torch.tensor([s_len - 1, s_len // 3], dtype=torch.int32)
    ctx = pa.paged_decode_attention(q, k, v, bt, pos)
    lim = pa.paged_limit(q, k, v, bt, pos, ctx)
    d_max, a, n, o, s, h = pa._limit_terms(q[:, :, None], k, v, bt, pos,
                                           ctx[:, :, None], None, None,
                                           None, None)
    walk = pa._paged_terms(q, d_max, a, n, o, s, h)[:, :, 0]
    extra = (pa._U * (2 * d_max + pa.paged_parts(s_len) + 4)
             * (a + o))[:, :, 0]
    assert bool((lim >= walk).all())
    torch.testing.assert_close(lim - walk, extra, rtol=1e-5, atol=0)


def test_paged_attention_checks_operands():
    q = torch.zeros(2, 2, 8)
    k = torch.zeros(5, 2, 4, 8)
    bt = torch.full((2, 2), 2, dtype=torch.int32)
    pos = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="int8 pool needs"):
        pa.paged_decode_attention(q, k, k, bt, pos, torch.zeros(5, 2),
                                  torch.zeros(5, 2))
    with pytest.raises(ValueError, match="block_tables must be int32"):
        pa.paged_decode_attention(q, k, k, bt.long(), pos)
    with pytest.raises(ValueError, match="heads/head_dim"):
        pa.paged_decode_attention(q, torch.zeros(5, 3, 4, 8),
                                  torch.zeros(5, 3, 4, 8), bt, pos)
    with pytest.raises(RuntimeError, match="needs CUDA tensors"):
        pa.paged_decode_attention_kernel(q, k, k, bt, pos)

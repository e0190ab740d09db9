"""Port parity: ``apex_tpu_torch`` flash-attention forward against the
JAX package, both its Pallas kernel (interpret mode on the CPU,
``use_kernel=True``) and its unfused path (``use_kernel=False``). The
port runs on the CPU, i.e. its plain version (the port of
``_unfused_attention``); the CUDA kernel is held against that version
on the card (``tests/test_torch_kernels_cuda.py`` and ``chip_smoke.py``).

Tolerances: fp32 1e-5; bf16 2e-2 (the kernel rounds the prescaled q and
the unnormalised p to bf16 where the unfused path rounds the
normalised p; inputs are O(1)). The dropout hash is held to JAX
exactly."""

import importlib

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from apex_tpu_torch.models.gpt import _split_qkv
from apex_tpu_torch.utils import prng

# the packages re-export the function under the module's name
jax_fa = importlib.import_module(
    "apex_tpu.transformer.functional.flash_attention")
port_fa = importlib.import_module(
    "apex_tpu_torch.transformer.functional.flash_attention")

_TOL = {"f32": 1e-5, "bf16": 2e-2}


def _np(a, dt):
    a = np.asarray(a, np.float32)
    return a.astype(ml_dtypes.bfloat16) if dt == "bf16" else a


def _torch(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x).astype(np.float32)


def _inputs(s, d, dt, seed=0, b=2, h=2):
    rng = np.random.RandomState(seed)
    q, k, v = (_np(rng.randn(b, h, s, d), dt) for _ in range(3))
    # batch 0: first key masked (so under causal its row 0 sees nothing)
    # plus a padded tail; batch 1: a padded tail only
    mask = np.ones((b, s), np.int32)
    mask[0, 0] = 0
    mask[0, s - 5:] = 0
    mask[1, s - 9:] = 0
    return q, k, v, mask


_CASES = [
    # (s, d, causal, masked, dtype)
    (40, 16, False, True, "f32"),
    (40, 64, True, False, "f32"),
    (130, 64, True, True, "f32"),
    (130, 16, False, False, "bf16"),
    (40, 64, True, True, "bf16"),
    (130, 64, False, True, "bf16"),
]


@pytest.mark.parametrize("s,d,causal,masked,dt", _CASES)
def test_forward_matches_jax(s, d, causal, masked, dt):
    q, k, v, mask = _inputs(s, d, dt)
    m = mask if masked else None
    got = port_fa.flash_attention(
        _torch(q), _torch(k), _torch(v),
        None if m is None else torch.from_numpy(m), causal=causal)
    assert got.dtype == _torch(q).dtype and got.shape == (2, 2, s, d)
    got = _f32(got)
    for use_kernel in (True, False):
        want = jax_fa.flash_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            None if m is None else jnp.asarray(m), causal=causal,
            use_kernel=use_kernel)
        np.testing.assert_allclose(got, _f32(want), rtol=_TOL[dt],
                                   atol=_TOL[dt])
    if masked and causal:
        # batch 0, query 0 can only see key 0, which is masked
        assert np.all(got[0, :, 0] == 0.0)


@pytest.mark.parametrize("rate", [0.1, 0.5, 0.9])
def test_hash_keep_equals_jax_exactly(rate):
    rng = np.random.RandomState(1)
    full = np.iinfo(np.uint32).max
    qpos, kpos, head = (rng.randint(0, full, size=(48, 64), dtype=np.uint64)
                        .astype(np.uint32) for _ in range(3))
    lo, hi = (int(x) for x in rng.randint(0, full, size=2, dtype=np.uint64))
    want = jax_fa._hash_keep(jnp.asarray(qpos), jnp.asarray(kpos),
                             jnp.asarray(head), jnp.uint32(lo),
                             jnp.uint32(hi), rate)
    got = port_fa.hash_keep(*(torch.from_numpy(a.astype(np.int64))
                              for a in (qpos, kpos, head)), lo, hi, rate)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_dropout_matches_jax(dt):
    s, d = 130, 16
    q, k, v, mask = _inputs(s, d, dt, seed=2)
    rng = jax.random.PRNGKey(7)
    got = _f32(port_fa.flash_attention(
        _torch(q), _torch(k), _torch(v), torch.from_numpy(mask),
        causal=True, dropout_rate=0.1, dropout_rng=prng.PRNGKey(7)))
    for use_kernel in (True, False):
        want = jax_fa.flash_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            jnp.asarray(mask), causal=True, dropout_rate=0.1,
            dropout_rng=rng, use_kernel=use_kernel)
        np.testing.assert_allclose(got, _f32(want), rtol=_TOL[dt],
                                   atol=_TOL[dt])
    # dropout without a key is off, as in JAX
    off = _f32(port_fa.flash_attention(
        _torch(q), _torch(k), _torch(v), torch.from_numpy(mask),
        causal=True, dropout_rate=0.1))
    assert not np.allclose(off, got)


def test_plain_lse_is_base2_logsumexp():
    q, k, v, mask = _inputs(40, 16, "f32")
    t = [_torch(a) for a in (q, k, v)]
    _, lse = port_fa.attention_fwd_plain(
        *t, torch.from_numpy(mask), (0, 0), causal=True, scale=0.25,
        rate=0.0)
    s = np.einsum("bhqd,bhkd->bhqk", q.astype(np.float64),
                  k.astype(np.float64)) * 0.25
    valid = (mask[:, None, None, :] != 0) & np.tril(np.ones((40, 40),
                                                            bool))
    with np.errstate(divide="ignore"):
        want = np.log2(np.where(valid, np.exp(s), 0.0).sum(-1))
    want = np.where(np.isfinite(want), want, np.inf).reshape(4, 40)
    assert bool(torch.isinf(lse[0, 0])) and np.isinf(want[0, 0])
    np.testing.assert_allclose(lse.numpy(), want, rtol=1e-5, atol=1e-5)


_BWD_CASES = [
    # (s, d, causal, masked, dtype, rate)
    (40, 16, False, True, "f32", 0.0),
    (40, 64, True, False, "f32", 0.0),
    (130, 64, True, True, "f32", 0.0),
    (130, 16, False, True, "f32", 0.2),
    (130, 16, False, False, "bf16", 0.0),
    (40, 64, True, True, "bf16", 0.0),
    (130, 64, False, True, "bf16", 0.0),
    (130, 16, True, True, "bf16", 0.2),
    # the bf16 dq kernel's 64-row q tile: one row short, one row over,
    # and a causal case whose last q tile holds one row
    (63, 64, False, True, "bf16", 0.0),
    (65, 64, True, True, "bf16", 0.1),
    (129, 64, True, False, "bf16", 0.0),
]


@pytest.mark.parametrize("s,d,causal,masked,dt,rate", _BWD_CASES)
def test_backward_matches_jax_bwd_call(s, d, causal, masked, dt, rate):
    """``attention_bwd_plain`` against the JAX ``_bwd_call`` (its dq and
    dk/dv Pallas kernels in interpret mode), both fed JAX's forward o
    and base-2 lse. fp32: 1e-4 relative + 2e-5 absolute (sums over keys
    in other orders). bf16: both sides round p, ds and the outputs to
    bf16 from fp32 values computed in other orders, so an element may
    sit a few ulps away: 2^-6 relative plus 2^-8 of the largest
    magnitude in its tensor."""
    q, k, v, mask = _inputs(s, d, dt, seed=3)
    do = _np(np.random.RandomState(4).randn(*q.shape), dt)
    m = mask if masked else None
    seed = (0x1234ABCD, 0x9876FEDC)
    scale = d ** -0.5
    jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, do))
    jm = None if m is None else jnp.asarray(m)
    jseed = jnp.asarray(seed, jnp.uint32)
    kw = dict(causal=causal, scale=scale, rate=rate, seed=jseed,
              interpret=True)
    o, lse_p = jax_fa._fwd_call(jq, jk, jv, jm, **kw)
    want = jax_fa._bwd_call(jq, jk, jv, jm, o, lse_p, jdo, **kw)
    lse = _torch(np.asarray(lse_p)[:, 0, :s].copy())
    got = port_fa.attention_bwd_plain(
        _torch(q), _torch(k), _torch(v),
        None if m is None else torch.from_numpy(m),
        _torch(np.array(o)), lse, _torch(do), seed, causal=causal,
        scale=scale, rate=rate)
    for g, w in zip(got, want):
        assert g.dtype == _torch(q).dtype and g.shape == q.shape
        g, w = _f32(g), _f32(w)
        assert np.all(np.isfinite(g))
        if dt == "f32":
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=2e-5)
        else:
            lim = 2.0 ** -6 * np.abs(w) + 2.0 ** -8 * np.abs(w).max()
            assert np.all(np.abs(g - w) <= lim)
    if masked and causal:
        # batch 0, query 0 sees no key: zero dq, not NaN
        assert np.all(_f32(got[0])[0, :, 0] == 0.0)


@pytest.mark.parametrize("causal,masked,rate", [
    (False, True, 0.0), (True, True, 0.0), (True, False, 0.3)])
def test_backward_plain_matches_autograd(causal, masked, rate):
    """fp32: the plain backward (the kernels' numerics) against torch
    autograd through the plain forward, 1e-5: the algebra is the same,
    the summation order and exp2 vs exp differ."""
    q, k, v, mask = _inputs(40, 16, "f32", seed=5)
    do = torch.from_numpy(np.random.RandomState(6).randn(*q.shape)).float()
    m = torch.from_numpy(mask) if masked else None
    seed = (7, 8)
    kw = dict(causal=causal, scale=0.25, rate=rate)
    ts = [_torch(a).requires_grad_(True) for a in (q, k, v)]
    o, lse = port_fa.attention_fwd_plain(*ts, m, seed, **kw)
    want = torch.autograd.grad(o, ts, do)
    got = port_fa.attention_bwd_plain(*[t.detach() for t in ts], m,
                                      o.detach(), lse, do, seed, **kw)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)


def test_flash_attention_autograd_uses_the_backward(monkeypatch):
    """``flash_attention``'s backward is the plain backward on the CPU,
    fed the forward's o and lse; gradients reach q, k and v."""
    q, k, v, mask = _inputs(40, 16, "f32")
    calls = []
    orig = port_fa.attention_bwd_plain
    monkeypatch.setattr(port_fa, "attention_bwd_plain",
                        lambda *a, **kw: calls.append(1) or orig(*a, **kw))
    ts = [_torch(a).requires_grad_(True) for a in (q, k, v)]
    out = port_fa.flash_attention(*ts, torch.from_numpy(mask), causal=True)
    grads = torch.autograd.grad(out.sum(), ts)
    assert calls == [1]
    assert all(g.shape == t.shape and bool(torch.isfinite(g).all())
               for g, t in zip(grads, ts))


def test_kernel_wrapper_refuses_cpu_tensors():
    q, k, v, _ = _inputs(40, 16, "f32")
    kernels = (port_fa.FLASH_FWD, port_fa.FLASH_BWD_DQ,
               port_fa.FLASH_BWD_DKV)
    before = [kk.launches for kk in kernels]
    t = [_torch(a) for a in (q, k, v)]
    kw = dict(causal=True, scale=0.25, rate=0.0)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_fa.attention_fwd_kernel(*t, None, (0, 0), **kw)
    o, lse = port_fa.attention_fwd_plain(*t, None, (0, 0), **kw)
    for fn in (port_fa.attention_dq_kernel, port_fa.attention_dkv_kernel):
        with pytest.raises(RuntimeError, match="CUDA"):
            fn(*t, None, o, lse, lse, (0, 0), **kw)
    assert [kk.launches for kk in kernels] == before


def _row_views(layout, b, s, h, d):
    """q, k, v as the model paths hand them to the kernels: BERT's views
    of a (b, s, 3, h, d) projection, GPT's ``_split_qkv`` views of a
    (b, s, 3 h d) head-major one, contiguous tensors, or BERT's views
    one element off a 16-byte boundary."""
    if layout == "gpt":
        return _split_qkv(torch.zeros((b, s, 3 * h * d),
                                      dtype=torch.bfloat16), d)
    if layout == "contiguous":
        return tuple(torch.zeros((b, h, s, d), dtype=torch.bfloat16)
                     for _ in range(3))
    n = b * s * 3 * h * d
    off = 1 if layout == "bert_shifted" else 0
    qkv = torch.zeros(n + 1, dtype=torch.bfloat16)[off:off + n].view(
        b, s, 3, h, d)
    return tuple(qkv[:, :, j].transpose(1, 2) for j in range(3))


def _rows16(t: torch.Tensor) -> bool:
    """The C entries' rule for 16-byte ``cp.async`` tiles (``rows_aligned``
    in ``csrc/flash_attention.cu``): every (batch, head, seq) row of the
    bf16 tensor starts on a 16-byte boundary, and its d elements fill
    whole copies. Addresses are byte offsets from the allocation, which
    is 16-byte aligned on the card as on the CPU."""
    es = t.element_size()
    return (t.shape[-1] * es % 16 == 0
            and t.storage_offset() * es % 16 == 0
            and all(st * es % 16 == 0 for st in t.stride()[:3]))


@pytest.mark.parametrize("layout,d,want", [
    ("bert", 64, True), ("gpt", 64, True), ("contiguous", 64, True),
    ("bert", 128, True), ("gpt", 48, True), ("bert", 100, False),
    ("gpt", 100, False), ("contiguous", 100, False),
    ("bert_shifted", 64, False)])
def test_model_views_take_the_copy_variant(layout, d, want):
    """The bf16 tensor-core kernels copy tiles by 16-byte ``cp.async``
    where q, k and v all meet the C entry's row rule, else by element
    loads: the q, k, v views the BERT and GPT paths hand over at d = 64
    (and 48, 128) take the copies, d = 100 (200-byte rows) and views one
    element off a boundary take element loads."""
    views = _row_views(layout, 2, 130, 4, d)
    assert all(_rows16(t) for t in views) is want
    assert views[0].data_ptr() % 16 == (2 if layout == "bert_shifted" else 0)


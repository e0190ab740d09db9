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
    seed = tuple(int(x) for x in jax.random.bits(rng, (2,), jnp.uint32))
    got = _f32(port_fa.flash_attention(
        _torch(q), _torch(k), _torch(v), torch.from_numpy(mask),
        causal=True, dropout_rate=0.1, dropout_seed=seed))
    for use_kernel in (True, False):
        want = jax_fa.flash_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            jnp.asarray(mask), causal=True, dropout_rate=0.1,
            dropout_rng=rng, use_kernel=use_kernel)
        np.testing.assert_allclose(got, _f32(want), rtol=_TOL[dt],
                                   atol=_TOL[dt])
    # dropout without a seed is off, as in JAX without a key
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


def test_backward_raises():
    q, k, v, _ = _inputs(40, 16, "f32")
    qt = _torch(q).requires_grad_(True)
    out = port_fa.flash_attention(qt, _torch(k), _torch(v), causal=True)
    with pytest.raises(NotImplementedError, match="later slice"):
        out.sum().backward()


def test_kernel_wrapper_refuses_cpu_tensors():
    q, k, v, _ = _inputs(40, 16, "f32")
    before = port_fa.FLASH_FWD.launches
    with pytest.raises(RuntimeError, match="CUDA"):
        port_fa.attention_fwd_kernel(
            _torch(q), _torch(k), _torch(v), None, (0, 0), causal=True,
            scale=0.25, rate=0.0)
    assert port_fa.FLASH_FWD.launches == before


"""Port parity: ``apex_tpu_torch`` LayerNorm/RMSNorm forward against the
JAX package's Pallas kernel (interpret mode on the CPU, as its own tests
run it). The port runs on the CPU, i.e. its plain PyTorch version; the
CUDA kernel is held against that version on the card
(``tests/test_torch_kernels_cuda.py`` and ``chip_smoke.py``).

Tolerances: fp32 outputs within 1e-5 of JAX; bf16 outputs within one
bf16 ulp of a float64 reference computed from the same bf16 inputs
(both sides compute in fp32 and round once, so they can differ only by
where that one rounding lands)."""

import importlib

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from apex_tpu import normalization as jax_norm
from apex_tpu_torch import normalization as port_norm
from apex_tpu_torch.normalization.fused_layer_norm import (
    LN_BWD, LN_FWD, layer_norm_bwd_kernel, layer_norm_bwd_plain,
    layer_norm_fwd_kernel, layer_norm_fwd_plain,
)

_DT = {"f32": (np.float32, torch.float32),
       "bf16": (ml_dtypes.bfloat16, torch.bfloat16)}


def _np(a, dt):
    return np.asarray(a, np.float32).astype(_DT[dt][0])


def _torch(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _f64(t):
    return t.detach().float().numpy().astype(np.float64)


def _ref(x, w, b, mode, eps=1e-5):
    """float64 reference on the (already rounded) inputs."""
    x = x.astype(np.float64)
    if mode == "ln":
        xc = x - x.mean(1, keepdims=True)
    else:
        xc = x
    y = xc / np.sqrt((xc * xc).mean(1, keepdims=True) + eps)
    if w is not None:
        y = y * w.astype(np.float64)
    if b is not None:
        y = y + b.astype(np.float64)
    return y


def _bf16_ulp(y):
    mag = np.maximum(np.abs(y), np.finfo(np.float32).tiny)
    return 2.0 ** (np.floor(np.log2(mag)) - 7)


def _inputs(rows, h, xdt, wdt, seed=0):
    rng = np.random.RandomState(seed)
    x = _np(rng.randn(rows, h) * 2.0 + 0.5, xdt)
    w = _np(1.0 + 0.5 * rng.randn(h), wdt)
    b = _np(0.3 * rng.randn(h), wdt)
    return x, w, b


_CASES = [
    # (rows, h, x dtype, w/b dtype, mode, affine)
    (7, 64, "f32", "f32", "ln", True),
    (64, 1000, "f32", "f32", "ln", True),
    (7, 1024, "f32", "f32", "rms", True),
    (64, 64, "f32", "f32", "ln", False),
    (7, 1000, "bf16", "bf16", "ln", True),
    (64, 1024, "bf16", "bf16", "ln", True),
    (64, 64, "bf16", "bf16", "rms", True),
    (7, 1000, "bf16", "f32", "ln", True),
    (64, 1024, "bf16", "f32", "rms", True),
    (7, 1024, "bf16", "bf16", "rms", False),
    (64, 1000, "f32", "bf16", "ln", True),
]


@pytest.mark.parametrize("rows,h,xdt,wdt,mode,affine", _CASES)
def test_forward_matches_jax(rows, h, xdt, wdt, mode, affine):
    x, w, b = _inputs(rows, h, xdt, wdt)
    if mode == "ln" and affine:
        want = jax_norm.fused_layer_norm_affine(
            jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), h)
        got = port_norm.fused_layer_norm_affine(
            _torch(x), _torch(w), _torch(b), h)
        ref = _ref(x, w, b, "ln")
    elif mode == "ln":
        want = jax_norm.fused_layer_norm(jnp.asarray(x), h)
        got = port_norm.fused_layer_norm(_torch(x), h)
        ref = _ref(x, None, None, "ln")
    elif affine:
        want = jax_norm.fused_rms_norm_affine(jnp.asarray(x),
                                              jnp.asarray(w), h)
        got = port_norm.fused_rms_norm_affine(_torch(x), _torch(w), h)
        ref = _ref(x, w, None, "rms")
    else:
        want = jax_norm.fused_rms_norm(jnp.asarray(x), h)
        got = port_norm.fused_rms_norm(_torch(x), h)
        ref = _ref(x, None, None, "rms")
    assert got.dtype == _DT[xdt][1] and tuple(got.shape) == (rows, h)
    want = np.asarray(want).astype(np.float64)
    got = _f64(got)
    if xdt == "f32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        ulp = _bf16_ulp(ref)
        assert np.all(np.abs(got - ref) <= ulp)
        assert np.all(np.abs(got - want) <= _bf16_ulp(want))


@pytest.mark.parametrize("mode", ["ln", "rms"])
def test_plain_statistics(mode):
    """mean (LN only) and rstd come out fp32, one per row."""
    x, w, b = _inputs(7, 1000, "bf16", "bf16")
    y, mean, rstd = layer_norm_fwd_plain(_torch(x), _torch(w), _torch(b),
                                         mode, 1e-5)
    xf = x.astype(np.float64)
    if mode == "ln":
        assert mean.dtype == torch.float32 and mean.shape == (7, 1)
        np.testing.assert_allclose(mean.numpy()[:, 0], xf.mean(1),
                                   rtol=1e-5, atol=1e-6)
        var = xf.var(1)
    else:
        assert mean is None
        var = (xf * xf).mean(1)
    assert rstd.dtype == torch.float32 and rstd.shape == (7, 1)
    np.testing.assert_allclose(rstd.numpy()[:, 0], 1 / np.sqrt(var + 1e-5),
                               rtol=1e-5)


@pytest.mark.parametrize("cls", ["FusedLayerNorm", "FusedRMSNorm",
                                 "MixedFusedLayerNorm", "MixedFusedRMSNorm"])
def test_modules(cls):
    x, _, _ = _inputs(7, 64, "bf16", "f32")
    mod = getattr(port_norm, cls)(64, param_dtype=torch.bfloat16)
    mode = "rms" if "RMS" in cls else "ln"
    want_dtype = torch.float32 if cls.startswith("Mixed") \
        else torch.bfloat16
    assert mod.weight.dtype == want_dtype
    assert (mod.bias is None) == (mode == "rms")
    got = mod(_torch(x).reshape(7, 1, 64))
    assert got.shape == (7, 1, 64) and got.dtype == torch.bfloat16
    np.testing.assert_allclose(_f64(got).reshape(7, 64),
                               _ref(x, None, None, mode), rtol=1e-2,
                               atol=1e-2)


_ENTRY = {  # (mode, affine) -> entry point name
    ("ln", True): "fused_layer_norm_affine",
    ("ln", False): "fused_layer_norm",
    ("rms", True): "fused_rms_norm_affine",
    ("rms", False): "fused_rms_norm",
}

_BWD_CASES = [
    # (rows, h, x dtype, w/b dtype, mode, affine)
    (7, 64, "f32", "f32", "ln", True),
    (33, 1000, "f32", "f32", "ln", True),
    (7, 1000, "f32", "f32", "ln", False),
    (33, 64, "f32", "f32", "rms", True),
    (7, 1000, "f32", "f32", "rms", False),
    (33, 1000, "bf16", "f32", "ln", True),     # BERT O2: bf16 x, fp32 w, b
    (7, 1024, "bf16", "bf16", "ln", True),     # GPT O2: bf16 throughout
    (33, 1000, "bf16", "f32", "rms", True),
    (7, 64, "bf16", "bf16", "rms", False),
    (16, 4096, "f32", "f32", "ln", True),      # JAX: column-split path
    (16, 4096, "bf16", "f32", "rms", True),    # JAX: column-split path
]


@pytest.mark.parametrize("rows,h,xdt,wdt,mode,affine", _BWD_CASES)
def test_backward_matches_jax(monkeypatch, rows, h, xdt, wdt, mode, affine):
    """dx, dgamma, dbeta against ``jax.vjp`` of the JAX function (its
    Pallas backward in interpret mode). fp32 results: 1e-4 relative +
    1e-5 absolute (two fp32 row reductions and a column sum, added in
    other orders); bf16 dx: one bf16 ulp of the JAX value plus 1e-5
    (both round one fp32 value). dgamma and dbeta come out in the
    param dtype, fp32 here even when x is bf16."""
    jax_ln = importlib.import_module(
        "apex_tpu.normalization.fused_layer_norm")
    colsplit = []
    orig = jax_ln._bwd_call_colsplit
    monkeypatch.setattr(jax_ln, "_bwd_call_colsplit",
                        lambda *a: colsplit.append(1) or orig(*a))
    x, w, b = _inputs(rows, h, xdt, wdt)
    dy = _np(np.random.RandomState(1).randn(rows, h), xdt)
    params = [w] + ([b] if mode == "ln" else []) if affine else []
    name = _ENTRY[(mode, affine)]

    def jax_fn(x_, *ps):
        return getattr(jax_norm, name)(x_, *ps, h)

    _, vjp = jax.vjp(jax_fn, jnp.asarray(x), *map(jnp.asarray, params))
    want = vjp(jnp.asarray(dy))
    assert bool(colsplit) == (h == 4096)

    ts = [_torch(a).requires_grad_(True) for a in [x] + params]
    y = getattr(port_norm, name)(ts[0], *ts[1:], h)
    got = torch.autograd.grad(y, ts, _torch(dy))
    for g, t, wv in zip(got, ts, want):
        assert g.dtype == t.dtype and g.shape == t.shape
        g, wv = _f64(g), np.asarray(wv).astype(np.float64)
        if t.dtype == torch.bfloat16:
            assert np.all(np.abs(g - wv) <= _bf16_ulp(wv) + 1e-5)
        else:
            np.testing.assert_allclose(g, wv, rtol=1e-4, atol=1e-5)


def test_backward_plain_matches_autograd():
    """The plain backward equals torch autograd through the plain
    forward (fp32, both: 1e-5, the two differ only in summation
    order)."""
    x, w, b = map(_torch, _inputs(9, 100, "f32", "f32"))
    dy = torch.from_numpy(np.random.RandomState(2).randn(9, 100)).float()
    for mode in ("ln", "rms"):
        bb = b if mode == "ln" else None
        ts = [t.clone().requires_grad_(True) for t in (x, w)]
        y, _, _ = layer_norm_fwd_plain(ts[0], ts[1], bb, mode, 1e-5)
        want = torch.autograd.grad(y, ts, dy)
        _, mean, rstd = layer_norm_fwd_plain(x, w, bb, mode, 1e-5)
        dx, dw, db = layer_norm_bwd_plain(dy, x, w, bb, mean, rstd)
        torch.testing.assert_close(dx, want[0], rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(dw, want[1], rtol=1e-5, atol=1e-5)
        assert (db is None) == (mode == "rms")
        if db is not None:
            torch.testing.assert_close(db, dy.sum(0), rtol=1e-5, atol=1e-5)


def test_kernel_wrapper_refuses_cpu_tensors():
    x, w, b = _inputs(7, 64, "f32", "f32")
    before = LN_FWD.launches, LN_BWD.launches
    xt, wt, bt = _torch(x), _torch(w), _torch(b)
    with pytest.raises(RuntimeError, match="CUDA"):
        layer_norm_fwd_kernel(xt, wt, bt, "ln", 1e-5)
    _, mean, rstd = layer_norm_fwd_plain(xt, wt, bt, "ln", 1e-5)
    with pytest.raises(RuntimeError, match="CUDA"):
        layer_norm_bwd_kernel(xt, xt, wt, bt, mean, rstd)
    assert (LN_FWD.launches, LN_BWD.launches) == before


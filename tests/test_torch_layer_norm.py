"""Port parity: ``apex_tpu_torch`` LayerNorm/RMSNorm forward against the
JAX package's Pallas kernel (interpret mode on the CPU, as its own tests
run it). The port runs on the CPU, i.e. its plain PyTorch version; the
CUDA kernel is held against that version on the card
(``tests/test_torch_kernels_cuda.py`` and ``chip_smoke.py``).

Tolerances: fp32 outputs within 1e-5 of JAX; bf16 outputs within one
bf16 ulp of a float64 reference computed from the same bf16 inputs
(both sides compute in fp32 and round once, so they can differ only by
where that one rounding lands)."""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from apex_tpu import normalization as jax_norm
from apex_tpu_torch import normalization as port_norm
from apex_tpu_torch.normalization.fused_layer_norm import (
    LN_FWD, layer_norm_fwd_kernel, layer_norm_fwd_plain,
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


def test_backward_raises():
    x, w, b = _inputs(7, 64, "f32", "f32")
    xt = _torch(x).requires_grad_(True)
    y = port_norm.fused_layer_norm_affine(xt, _torch(w), _torch(b), 64)
    with pytest.raises(NotImplementedError, match="later slice"):
        y.sum().backward()


def test_kernel_wrapper_refuses_cpu_tensors():
    x, w, b = _inputs(7, 64, "f32", "f32")
    before = LN_FWD.launches
    with pytest.raises(RuntimeError, match="CUDA"):
        layer_norm_fwd_kernel(_torch(x), _torch(w), _torch(b), "ln", 1e-5)
    assert LN_FWD.launches == before


"""Port parity: ``apex_tpu_torch.contrib.xentropy`` against the JAX
package's softmax cross entropy (its Pallas forward and backward in
interpret mode on the CPU). The port runs on the CPU, i.e. its plain
versions; the CUDA kernels are held against those on the card
(``tests/test_torch_kernels_cuda.py`` and ``chip_smoke.py``).

Tolerances: fp32 losses and gradients within 1e-5 relative + 1e-6
absolute of JAX (a logsumexp over 1000 logits summed in another order);
bf16 gradients within one bf16 ulp of the JAX value plus 1e-6 (both
round one fp32 value)."""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from apex_tpu.contrib import xentropy as jax_xent
from apex_tpu_torch.contrib import xentropy as port_xent

N, V = 24, 1000


def _torch(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _inputs(dt, seed=0):
    rng = np.random.RandomState(seed)
    x = (rng.randn(N, V) * 3.0).astype(np.float32)
    if dt == "bf16":
        x = x.astype(ml_dtypes.bfloat16)
    labels = rng.randint(0, V, size=N).astype(np.int64)
    labels[[1, 5, 6, 20]] = -1           # ignored rows
    dloss = rng.rand(N).astype(np.float32) + 0.5
    return x, labels, dloss


def _ulp(y):
    mag = np.maximum(np.abs(y), np.finfo(np.float32).tiny)
    return 2.0 ** (np.floor(np.log2(mag)) - 7)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("eps", [0.0, 0.1])
def test_forward_and_backward_match_jax(dt, eps):
    x, labels, dloss = _inputs(dt)
    loss_j, vjp = jax.vjp(
        lambda a: jax_xent.softmax_cross_entropy_loss(
            a, jnp.asarray(labels.astype(np.int32)), eps), jnp.asarray(x))
    (dx_j,) = vjp(jnp.asarray(dloss))

    xt = _torch(x).requires_grad_(True)
    loss = port_xent.softmax_cross_entropy_loss(xt, torch.from_numpy(labels),
                                                eps)
    assert loss.dtype == torch.float32 and loss.shape == (N,)
    np.testing.assert_allclose(loss.detach().numpy(), np.asarray(loss_j),
                               rtol=1e-5, atol=1e-6)
    assert np.all(loss.detach().numpy()[labels < 0] == 0.0)
    (dx,) = torch.autograd.grad(loss, xt, torch.from_numpy(dloss))
    assert dx.dtype == xt.dtype and dx.shape == (N, V)
    got = dx.float().numpy().astype(np.float64)
    want = np.asarray(dx_j).astype(np.float64)
    assert np.all(got[labels < 0] == 0.0)
    if dt == "f32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    else:
        assert np.all(np.abs(got - want) <= _ulp(want) + 1e-6)


def test_plain_matches_log_softmax():
    """The plain versions against ``log_softmax`` and autograd through
    it (float32, 1e-5)."""
    x, labels, dloss = _inputs("f32", seed=1)
    xt = torch.from_numpy(x).requires_grad_(True)
    lab = torch.from_numpy(labels)
    logp = torch.log_softmax(xt, -1)
    live = lab >= 0
    want = torch.where(live, -logp.gather(1, lab.clamp(min=0)[:, None])[:, 0],
                       torch.zeros(()))
    (dwant,) = torch.autograd.grad(want, xt, torch.from_numpy(dloss))
    loss, lse = port_xent.xentropy_fwd_plain(xt.detach(), lab, 0.0)
    torch.testing.assert_close(loss, want.detach(), rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(lse, torch.logsumexp(xt.detach(), -1))
    dx = port_xent.xentropy_bwd_plain(xt.detach(), lab, lse,
                                      torch.from_numpy(dloss), 0.0)
    torch.testing.assert_close(dx, dwant, rtol=1e-5, atol=1e-6)


def test_padding_idx_shim():
    x, labels, _ = _inputs("f32", seed=2)
    labels[labels < 0] = 3
    labels[0] = 7
    got = port_xent.SoftmaxCrossEntropyLoss.apply(
        torch.from_numpy(x), torch.from_numpy(labels), padding_idx=7)
    want = jax_xent.SoftmaxCrossEntropyLoss.apply(
        jnp.asarray(x), jnp.asarray(labels.astype(np.int32)), padding_idx=7)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    assert float(got[0]) == 0.0


def test_kernel_wrappers_refuse_cpu_tensors():
    x, labels, dloss = _inputs("f32")
    xt, lab = torch.from_numpy(x), torch.from_numpy(labels)
    before = port_xent.XENT_FWD.launches, port_xent.XENT_BWD.launches
    with pytest.raises(RuntimeError, match="CUDA"):
        port_xent.xentropy_fwd_kernel(xt, lab, 0.0)
    _, lse = port_xent.xentropy_fwd_plain(xt, lab, 0.0)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_xent.xentropy_bwd_kernel(xt, lab, lse, torch.from_numpy(dloss),
                                      0.0)
    assert (port_xent.XENT_FWD.launches,
            port_xent.XENT_BWD.launches) == before

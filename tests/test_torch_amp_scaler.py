"""Port parity: ``apex_tpu_torch.amp`` loss scaling (``LossScaler``,
``Amp.value_and_grad``, ``apply_if_finite``) against the JAX package.
Scale, counters and found_inf are held exactly; unscaled gradients
within 1e-6 relative (one fp32 multiply by the same inverse scale)."""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from apex_tpu import amp as jax_amp
from apex_tpu.amp import scaler as jax_scaler
from apex_tpu.optimizers import FusedAdam as JaxAdam
from apex_tpu_torch import amp as port_amp
from apex_tpu_torch.amp import scaler as port_scaler
from apex_tpu_torch.optimizers import FusedAdam
from apex_tpu_torch.utils.tree import tree_leaves

def _to_jax(t):
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.view(torch.int16).numpy().view(
            ml_dtypes.bfloat16))
    return jnp.asarray(t.numpy())


def _state_tuple(s):
    return (float(s.loss_scale), int(s.unskipped), int(s.overflows))


def test_update_scale_sequence_matches_jax():
    """Overflows halve (floored at min), scale_window clean steps double
    (capped at max), the window resets on both."""
    kw = dict(init_scale=8.0, scale_window=3, min_loss_scale=2.0,
              max_loss_scale=32.0)
    js, ps = jax_scaler.LossScaler(**kw), port_scaler.LossScaler(**kw)
    jst, pst = js.init_state(), ps.init_state("cpu")
    pattern = [0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1]
    seen = []
    for f in pattern:
        jst = js.update_scale(jst, jnp.asarray(bool(f)))
        pst = ps.update_scale(pst, torch.tensor(bool(f)))
        assert _state_tuple(pst) == _state_tuple(jst)
        assert pst.loss_scale.dtype == torch.float32
        assert pst.unskipped.dtype == pst.overflows.dtype == torch.int32
        seen.append(float(pst.loss_scale))
    assert max(seen) == 32.0 and min(seen) == 2.0


def test_static_scale_never_moves():
    ps = port_scaler.LossScaler(loss_scale=128.0)
    st = ps.init_state("cpu")
    assert _state_tuple(ps.update_scale(st, torch.tensor(True))) == (
        128.0, 0, 0)


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16,
                                   torch.float32])
@pytest.mark.parametrize("bad", [None, "inf", "nan"])
def test_unscale_and_found_inf_match_jax(dtype, bad):
    rng = np.random.RandomState(0)
    grads = {"a": torch.from_numpy(rng.randn(5, 3).astype(np.float32)
                                   * 1000).to(dtype),
             "b": [torch.from_numpy(rng.randn(7).astype(np.float32))]}
    if bad:
        grads["b"][0][3] = float(bad)
    js, ps = jax_scaler.LossScaler(), port_scaler.LossScaler()
    jg, jf = js.unscale(jax.tree.map(_to_jax, grads), js.init_state())
    pg, pf = ps.unscale(grads, ps.init_state("cpu"))
    assert pf.dtype == torch.bool and pf.shape == ()
    assert bool(pf) == bool(jf) == (bad is not None)
    for w, g, t in zip(jax.tree.leaves(jg), tree_leaves(pg),
                       tree_leaves(grads)):
        assert g.dtype == t.dtype
        w = np.asarray(w).astype(np.float32)
        g = g.float().numpy()
        fin = np.isfinite(w)
        assert np.array_equal(fin, np.isfinite(g))
        np.testing.assert_allclose(g[fin], w[fin], rtol=1e-6)


def test_value_and_grad_tuple_matches_jax():
    """``(loss, grads, found_inf, new_state)``; grads of the scaled loss
    with respect to the compute tree (bf16 leaves stay bf16), unscaled;
    a leaf the loss never reaches gets zeros."""
    rng = np.random.RandomState(1)
    w = rng.randn(4, 3).astype(np.float32)
    x = rng.randn(6, 4).astype(np.float32)
    params = {"w": torch.from_numpy(w).to(torch.bfloat16),
              "ln": {"weight": torch.ones(3)},
              "unused": torch.ones(2, dtype=torch.bfloat16)}

    def port_loss(p, xx):
        y = (xx.to(torch.bfloat16) @ p["w"]).float() * p["ln"]["weight"]
        return (y * y).mean()

    def jax_loss(p, xx):
        y = (xx.astype(jnp.bfloat16) @ p["w"]).astype(jnp.float32) \
            * p["ln"]["weight"]
        return (y * y).mean()

    ph = port_amp.initialize("O2", verbosity=0)
    jh = jax_amp.initialize("O2", verbosity=0)
    pl, pg, pf, pst = ph.value_and_grad(port_loss)(
        params, ph.init_state("cpu"), torch.from_numpy(x))
    jl, jg, jf, jst = jh.value_and_grad(jax_loss)(
        jax.tree.map(_to_jax, params), jh.init_state(), jnp.asarray(x))
    np.testing.assert_allclose(float(pl), float(jl), rtol=1e-6)
    assert not pl.requires_grad
    assert bool(pf) == bool(jf) is False
    assert _state_tuple(pst) == _state_tuple(jst) == (65536.0, 1, 0)
    assert pg["w"].dtype == torch.bfloat16
    assert pg["unused"].dtype == torch.bfloat16
    assert bool((pg["unused"] == 0).all())
    for key in ("w", "unused"):
        np.testing.assert_allclose(pg[key].float().numpy(),
                                   np.asarray(jg[key]).astype(np.float32),
                                   rtol=2 ** -7, atol=1e-6)
    np.testing.assert_allclose(pg["ln"]["weight"].numpy(),
                               np.asarray(jg["ln"]["weight"]), rtol=1e-5)
    # the caller's tree is untouched
    assert not params["w"].requires_grad


def test_state_dict_round_trip():
    ps = port_scaler.LossScaler()
    st = ps.update_scale(ps.init_state("cpu"), torch.tensor(True))
    d = ps.state_dict(st)
    assert d == {"loss_scale": 32768.0, "unskipped": 0, "overflows": 1}
    back = ps.load_state_dict(d, "cpu")
    assert _state_tuple(back) == _state_tuple(st)
    jd = jax_scaler.LossScaler().state_dict(
        jax_scaler.LossScaler().load_state_dict(d))
    assert jd == d


def test_overflow_step_freezes_everything():
    """An inf gradient: found_inf True, the scale halves, and FusedAdam
    with emit_compute_params keeps master, m, v, the step count and
    the compute tree exactly as they were (JAX does the same)."""
    h = port_amp.initialize("O2", verbosity=0)
    master = {"k": torch.randn(3, 4, generator=torch.Generator()
                               .manual_seed(0)),
              "layernorm": {"weight": torch.ones(4)}}
    opt = FusedAdam(lr=1e-2, weight_decay=0.01, m_dtype=torch.bfloat16,
                    emit_compute_params=True)
    state = opt.init(master)
    compute = h.cast_model(master)
    scaler = h.init_state("cpu")

    def loss_fn(p):
        return (p["k"].float() * 1e36).sum() * p["layernorm"]["weight"].sum()

    loss, grads, found, scaler2 = h.value_and_grad(loss_fn)(compute, scaler)
    assert bool(found)
    assert float(scaler2.loss_scale) == 32768.0
    new_master, new_state, new_compute = opt.step(
        grads, master, state, found_inf=found, compute_params=compute)
    for a, b in ((new_master, master), (new_state.m, state.m),
                 (new_state.v, state.v), (new_compute, compute)):
        for x, y in zip(tree_leaves(a), tree_leaves(b)):
            assert x.dtype == y.dtype and torch.equal(x, y)
    assert int(new_state.step) == 0
    # JAX agrees on found_inf and on the frozen step count
    jh = jax_amp.initialize("O2", verbosity=0)
    jm = jax.tree.map(lambda t: jnp.asarray(t.numpy()), master)
    jopt = JaxAdam(lr=1e-2, weight_decay=0.01, m_dtype=jnp.bfloat16)
    _, jgr, jfound, _ = jh.value_and_grad(
        lambda p: (p["k"].astype(jnp.float32) * 1e36).sum()
        * p["layernorm"]["weight"].sum())(jh.cast_model(jm), jh.init_state())
    _, jst = jopt.step(jgr, jm, jopt.init(jm), found_inf=jfound)
    assert bool(jfound) and int(jst.step) == 0

"""Port parity of ``RNN/`` (cells and stacks) against the JAX package on
the CPU, the reference's ``tests/L0/run_rnn/test_rnn.py`` cases.

Every case runs the JAX function and the port's on the same inputs: the
JAX package's ``init_*`` weights and ``jax.random.normal`` inputs,
carried across as numpy. Each of the five cells at fp32 (1e-6 relative
and absolute; the gate math repeats JAX's operations, the products'
summation order aside); the LSTM stack against the port's cells
unrolled by hand and the JAX stack; the bidirectional GRU's
concatenation and reversal (the backward half at time 0 is its scan's
last state); the mLSTM against the LSTM on its shared weights; the
gradients of a 2-layer bidirectional LSTM against ``jax.grad`` (1e-5
relative, 1e-6 absolute); a bf16 ``params_dtype`` held, with the
outputs within 2^-6 relative (a few bf16 ulps) of JAX's and finite
gradients; the inter-layer dropout's keep masks equal to
``jax.random.bernoulli``'s bit for bit and the dropped stack JAX's; the
mode validation. This module imports no JAX at its top."""

import functools

import numpy as np
import pytest
import torch

from apex_tpu_torch.RNN import (
    GRU, LSTM, RNN, RNNReLU, RNNTanh, gru_cell, lstm_cell, mLSTM, mlstm_cell,
    rnn_relu_cell, rnn_tanh_cell,
)
from apex_tpu_torch.utils import prng

S, B, I, H = 6, 2, 5, 4
CELLS = {"lstm": lstm_cell, "mlstm": mlstm_cell, "gru": gru_cell,
         "rnn_tanh": rnn_tanh_cell, "rnn_relu": rnn_relu_cell}
MODELS = {"lstm": LSTM, "mlstm": mLSTM, "gru": GRU, "rnn_relu": RNNReLU,
          "rnn_tanh": RNNTanh}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(tree):
    """numpy (ml_dtypes bf16 too) -> torch, any nesting."""
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_t(v) for v in tree)
    a = np.asarray(tree)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _n(x):
    return x.detach().float().numpy()


# ---------------------------------------------------------------------------
# the JAX side (memoized; imported lazily)
# ---------------------------------------------------------------------------

def _normal(seed, shape, dtype=None):
    import jax
    import jax.numpy as jnp
    return np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape,
                                        dtype or jnp.float32))


@functools.lru_cache(maxsize=None)
def _jax_cell(mode):
    """(params, x, state, new state) of one JAX cell step."""
    import jax
    import jax.numpy as jnp

    from apex_tpu import RNN as jrnn

    init = {"lstm": jrnn.init_lstm_cell, "mlstm": jrnn.init_mlstm_cell,
            "gru": jrnn.init_gru_cell, "rnn_tanh": jrnn.init_rnn_cell,
            "rnn_relu": jrnn.init_rnn_cell}[mode]
    cell = {"lstm": jrnn.lstm_cell, "mlstm": jrnn.mlstm_cell,
            "gru": jrnn.gru_cell, "rnn_tanh": jrnn.rnn_tanh_cell,
            "rnn_relu": jrnn.rnn_relu_cell}[mode]
    p = init(jax.random.PRNGKey(0), I, H)
    x, h, c = (jnp.asarray(_normal(s, shp)) for s, shp in
               ((1, (B, I)), (2, (B, H)), (3, (B, H))))
    state = (h, c) if mode in ("lstm", "mlstm") else h
    new = cell(p, x, state)
    tree = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return tree(p), np.asarray(x), tree(state), tree(new)


@functools.lru_cache(maxsize=None)
def _jax_model(mode, layers, bidir, dropout=0.0, drop_seed=None,
               dtype="float32", grads=False):
    """(params, xs, out, finals[, grads of sum(out)]) of a JAX stack."""
    import jax
    import jax.numpy as jnp

    from apex_tpu.RNN import RNN as JRNN

    dt = getattr(jnp, dtype)
    model = JRNN(mode, I, H, num_layers=layers, dropout=dropout,
                 bidirectional=bidir, params_dtype=dt)
    params = model.init(jax.random.PRNGKey(0))
    xs = jnp.asarray(_normal(1, (S, B, I))).astype(dt)
    rng = None if drop_seed is None else jax.random.PRNGKey(drop_seed)
    out, finals = model.apply(params, xs, dropout_rng=rng)
    tree = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    res = [tree(params), np.asarray(xs), np.asarray(out), tree(finals)]
    if grads:
        res.append(tree(jax.grad(lambda p: jnp.sum(
            model.apply(p, xs, dropout_rng=rng)[0].astype(jnp.float32)))(
                params)))
    return tuple(res)


def _close(got, want, rtol=1e-6, atol=1e-6):
    if isinstance(want, dict):
        for k in want:
            _close(got[k], want[k], rtol, atol)
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _close(g, w, rtol, atol)
    else:
        np.testing.assert_allclose(_n(got), np.asarray(want, np.float32),
                                   rtol=rtol, atol=atol)


# ---------------------------------------------------------------------------
# cases
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", sorted(CELLS))
def test_cell_matches_jax(mode):
    p, x, state, want = _jax_cell(mode)
    got = CELLS[mode](_t(p), _t(x), _t(state))
    _close(got, want)


def test_lstm_cell_matches_manual():
    """The reference's hand-written LSTM step, on the port's cell."""
    p, x, (h, c), _ = _jax_cell("lstm")
    h2, c2 = lstm_cell(_t(p), _t(x), (_t(h), _t(c)))
    g = x @ p["w_ih"] + h @ p["w_hh"] + p["b_ih"] + p["b_hh"]
    i_, f, g_, o = np.split(g, 4, axis=-1)
    sig = lambda z: 1 / (1 + np.exp(-z))  # noqa: E731
    c_want = sig(f) * c + sig(i_) * np.tanh(g_)
    h_want = sig(o) * np.tanh(c_want)
    np.testing.assert_allclose(_n(h2), h_want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(_n(c2), c_want, rtol=1e-5, atol=1e-6)


def test_lstm_stack_equals_unrolled_cells():
    params, xs, want, _ = _jax_model("lstm", 2, False)
    model = LSTM(I, H, num_layers=2)
    out, finals = model.apply(_t(params), _t(xs))
    assert out.shape == (S, B, H) and len(finals) == 2
    cur = _t(xs)
    for layer in _t(params):
        h = torch.zeros(B, H)
        c = torch.zeros(B, H)
        outs = []
        for t in range(S):
            h, c = lstm_cell(layer["fwd"], cur[t], (h, c))
            outs.append(h)
        cur = torch.stack(outs)
    assert torch.equal(out, cur)
    _close(out, want)


@pytest.mark.parametrize("mode", sorted(MODELS))
def test_bidirectional_concat_and_reverse(mode):
    params, xs, want, want_fin = _jax_model(mode, 1, True)
    out, finals = MODELS[mode](I, H, bidirectional=True).apply(
        _t(params), _t(xs))
    assert out.shape == (S, B, 2 * H)
    fin_f, fin_b = finals[0]
    if mode in ("lstm", "mlstm"):
        fin_f, fin_b = fin_f[0], fin_b[0]
    # the backward half at time 0 is the reversed run's last state
    assert torch.equal(out[-1, :, :H], fin_f)
    assert torch.equal(out[0, :, H:], fin_b)
    _close(out, want)
    _close(finals, want_fin)


def test_mlstm_runs_and_differs_from_lstm():
    p, x, (h, c), _ = _jax_cell("mlstm")
    p, x, h = _t(p), _t(x), _t(h)
    c = torch.zeros(B, H)
    h2, _ = mlstm_cell(p, x, (h, c))
    assert h2.shape == (B, H)
    h3, _ = lstm_cell({k: p[k] for k in ("w_ih", "w_hh", "b_ih", "b_hh")},
                      x, (h, c))
    assert float((h2 - h3).abs().max()) > 0


def test_gradients_of_bidirectional_stack_match_jax():
    params, xs, want, _, want_g = _jax_model("lstm", 2, True, grads=True)
    p = _t(params)
    for layer in p:
        for cell in layer.values():
            for v in cell.values():
                v.requires_grad_(True)
    out, _ = LSTM(I, H, num_layers=2, bidirectional=True).apply(p, _t(xs))
    _close(out, want)
    out.sum().backward()
    _close([{d: {k: v.grad for k, v in c.items()} for d, c in layer.items()}
            for layer in p], want_g, rtol=1e-5, atol=1e-6)


def test_bf16_params_dtype_held():
    """Gate math in fp32, the output in the input's dtype; the outputs
    within a few bf16 ulps of JAX's; finite gradients."""
    params, xs, want, _ = _jax_model("lstm", 2, False, 0.1, 2, "bfloat16")
    model = LSTM(I, H, num_layers=2, dropout=0.1,
                 params_dtype=torch.bfloat16)
    p = _t(params)
    assert all(v.dtype == torch.bfloat16 for layer in p
               for v in layer["fwd"].values())
    out, _ = model.apply(p, _t(xs), dropout_rng=prng.PRNGKey(2))
    assert out.dtype == torch.bfloat16
    _close(out, want, rtol=2.0 ** -6, atol=2.0 ** -8)
    for layer in p:
        for v in layer["fwd"].values():
            v.requires_grad_(True)
    model.apply(p, _t(xs).to(torch.bfloat16))[0].float().sum().backward()
    for layer in p:
        for v in layer["fwd"].values():
            assert bool(torch.isfinite(v.grad.float()).all())


def test_dropout_keep_masks_match_jax():
    """The keep mask of layer li is bernoulli(fold_in(key, li), 1 - p)
    over the layer's output shape, JAX's bits; no dropout after the last
    layer; the dropped stack gives JAX's outputs."""
    import jax

    key = jax.random.PRNGKey(7)
    for li, shape in ((0, (S, B, 2 * H)), (1, (S, B, 2 * H))):
        want = np.asarray(jax.random.bernoulli(
            jax.random.fold_in(key, li), 0.7, shape))
        got = prng.bernoulli(prng.fold_in(prng.PRNGKey(7), li), 0.7, shape,
                             device="cpu")
        np.testing.assert_array_equal(got.numpy(), want)
    params, xs, want, _ = _jax_model("lstm", 3, True, 0.3, 7)
    out, _ = LSTM(I, H, num_layers=3, dropout=0.3,
                  bidirectional=True).apply(_t(params), _t(xs),
                                            dropout_rng=prng.PRNGKey(7))
    _close(out, want)
    plain, _ = LSTM(I, H, num_layers=3, bidirectional=True).apply(
        _t(params), _t(xs))
    assert not torch.equal(out, plain)


def test_mode_validation():
    with pytest.raises(ValueError, match="mode"):
        RNN("conv", I, H)

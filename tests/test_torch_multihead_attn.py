"""Port parity of ``contrib.multihead_attn`` (``SelfMultiheadAttn``,
``EncdecMultiheadAttn``) against the JAX package's modules on the CPU:
the six cases of ``tests/L0/run_transformer/test_multihead_attn.py``
(self attention, causal and not; a key padding mask; the norm-add
variant; encoder-decoder attention with s_q != s_k; dropout, deterministic
and with the JAX package's masks bit for bit; gradients), each on the JAX
module's params carried across by ``params_from_jax`` and the same
inputs. The JAX side runs its flash attention as its own tests do on the
CPU (the Pallas kernels in interpret mode); the port's runs its plain
versions.

Tolerances: fp32 outputs within rtol/atol 1e-5 of the JAX module's (the
reference test's tolerance against its straight-line attention; the
norm-add variant 1e-4 relative, as there); gradients within 1e-4
relative and 1e-5 absolute (sums over the batch and sequence in another
order); the output dropout's keep mask equal to ``jax.random.bernoulli``'s
bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.contrib import multihead_attn as jmha
from apex_tpu_torch.contrib import multihead_attn as pmha
from apex_tpu_torch.contrib.multihead_attn.multihead_attn import (
    params_from_jax,
)
from apex_tpu_torch.utils import prng
from apex_tpu_torch.utils.tree import tree_map

S, SK, B, H, NH = 16, 24, 2, 64, 8
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(cls, **kw):
    """(JAX module, port module, JAX params, port params)."""
    jm = getattr(jmha, cls)(H, NH, **kw)
    pm = getattr(pmha, cls)(H, NH, **kw)
    jp = jm.init(jax.random.PRNGKey(0))
    return jm, pm, jp, params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


def _x(seed, shape):
    x = jax.random.normal(jax.random.PRNGKey(seed), shape)
    return x, torch.from_numpy(np.array(x))


@pytest.mark.parametrize("causal", [False, True])
def test_self_attn_matches_jax(causal):
    jm, pm, jp, pp = _pair("SelfMultiheadAttn")
    jx, px = _x(1, (S, B, H))
    want = jm.apply(jp, jx, attn_mask_causal=causal, is_training=False)
    got = pm.apply(pp, px, attn_mask_causal=causal, is_training=False)
    assert got.shape == (S, B, H)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_self_attn_key_padding_mask():
    jm, pm, jp, pp = _pair("SelfMultiheadAttn")
    jx, px = _x(1, (S, B, H))
    mask = np.ones((B, S), np.int32)
    mask[:, S // 2:] = 0
    want = jm.apply(jp, jx, key_padding_mask=jnp.asarray(mask),
                    is_training=False)
    got = pm.apply(pp, px, key_padding_mask=torch.from_numpy(mask),
                   is_training=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_norm_add_variant():
    """LayerNorm at the input (the port's fused_layer_norm_affine),
    the residual at the output: the JAX module's output, and plain
    MHA(LN(x)) + x on the port."""
    jm, pm, jp, pp = _pair("SelfMultiheadAttn", include_norm_add=True)
    jx, px = _x(1, (S, B, H))
    want = jm.apply(jp, jx, is_training=False)
    got = pm.apply(pp, px, is_training=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)
    xn = torch.nn.functional.layer_norm(px, (H,), eps=1e-5)
    plain = pmha.SelfMultiheadAttn(H, NH).apply(
        {"qkv": pp["qkv"], "out": pp["out"]}, xn, is_training=False) + px
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=1e-4,
                               atol=1e-5)


def test_encdec_matches_jax():
    jm, pm, jp, pp = _pair("EncdecMultiheadAttn")
    jq, pq = _x(1, (S, B, H))
    je, pe = _x(2, (SK, B, H))
    want = jm.apply(jp, jq, je, is_training=False)
    got = pm.apply(pp, pq, pe, is_training=False)
    assert got.shape == (S, B, H)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_dropout_deterministic_and_the_jax_masks():
    """The attention's hash dropout and the norm-add epilogue's bernoulli
    mask: one key twice the same bits, another key other values, eval
    mode off; the output the JAX module's at the same key, and the
    epilogue's mask ``jax.random.bernoulli``'s bit for bit."""
    for kw in (dict(dropout=0.3), dict(dropout=0.3, include_norm_add=True)):
        jm, pm, jp, pp = _pair("SelfMultiheadAttn", **kw)
        jx, px = _x(1, (S, B, H))
        a = pm.apply(pp, px, dropout_rng=prng.PRNGKey(5))
        b = pm.apply(pp, px, dropout_rng=prng.PRNGKey(5))
        c = pm.apply(pp, px, dropout_rng=prng.PRNGKey(6))
        d = pm.apply(pp, px, is_training=False,
                     dropout_rng=prng.PRNGKey(5))
        assert torch.equal(a, b)
        assert float((a - c).abs().max()) > 0
        assert float((a - d).abs().max()) > 0
        want = jm.apply(jp, jx, dropout_rng=jax.random.PRNGKey(5))
        np.testing.assert_allclose(a.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-5)
    key = jax.random.split(jax.random.PRNGKey(5))[1]
    want = np.asarray(jax.random.bernoulli(key, 1 - 0.3, (S, B, H)))
    got = prng.bernoulli(prng.split(prng.PRNGKey(5))[1], 1 - 0.3,
                         (S, B, H), device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)


def test_gradients_match_jax():
    """d sum(out^2) / d params (bias, norm-add, causal): finite, nonzero,
    and the JAX module's gradients."""
    jm, pm, jp, pp = _pair("SelfMultiheadAttn", bias=True,
                           include_norm_add=True)
    jx, px = _x(1, (S, B, H))
    want = jax.grad(lambda p: jnp.sum(
        jm.apply(p, jx, attn_mask_causal=True, is_training=False) ** 2))(jp)
    leaves = tree_map(lambda t: t.clone().requires_grad_(True), pp)
    loss = (pm.apply(leaves, px, attn_mask_causal=True,
                     is_training=False) ** 2).sum()
    loss.backward()
    for name, p in leaves.items():
        for k, t in p.items():
            g = t.grad.numpy()
            assert np.all(np.isfinite(g)) and np.abs(g).max() > 0, (name, k)
            np.testing.assert_allclose(g, np.asarray(want[name][k]),
                                       rtol=1e-4, atol=1e-5,
                                       err_msg=f"{name}/{k}")

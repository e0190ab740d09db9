"""Port parity: ``apex_tpu_torch.optimizers.FusedAdam`` (tree path)
against the JAX package's, fed the same gradients. Both compute the
update in fp32 with fp32 constants in the same order, so m and v agree
bit for bit, a bf16 m included (fp32 accumulate, round to nearest even);
params within 1e-6 relative + 1e-9 (the bias-correction powers come
from two pow implementations)."""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from apex_tpu.optimizers import FusedAdam as JaxAdam
from apex_tpu_torch.optimizers import FusedAdam
from apex_tpu_torch.utils.tree import tree_leaves


def _to_torch(a):
    a = np.array(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _tree(seed):
    rng = np.random.RandomState(seed)
    return {"dense": {"kernel": rng.randn(8, 5).astype(np.float32),
                      "bias": rng.randn(5).astype(np.float32)},
            "layers": [rng.randn(3, 4).astype(np.float32),
                       rng.randn(6).astype(np.float32)]}


def _torch_tree(tree, dtype=None):
    return jax.tree.map(
        lambda a: _to_torch(a) if dtype is None
        else _to_torch(a).to(dtype), tree)


def _leaves(jax_tree):
    """JAX leaves in the port's visiting order (dict insertion order)."""
    return tree_leaves(jax.tree.map(_to_torch, jax_tree))


@pytest.mark.parametrize("m_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("adam_w_mode", [True, False])
def test_tree_steps_match_jax(m_dtype, adam_w_mode):
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[m_dtype]
    kw = dict(lr=1e-2, weight_decay=0.01, adam_w_mode=adam_w_mode)
    jopt, popt = JaxAdam(m_dtype=jdt, **kw), FusedAdam(m_dtype=tdt, **kw)
    jp = jax.tree.map(jnp.asarray, _tree(0))
    pp = _torch_tree(_tree(0))
    js, ps = jopt.init(jp), popt.init(pp)
    for step in range(3):
        g = _tree(10 + step)   # bf16 grads, as O2 hands them over
        jg = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), g)
        pg = _torch_tree(g, torch.bfloat16)
        jp, js = jopt.step(jg, jp, js)
        pp, ps = popt.step(pg, pp, ps)
        assert int(ps.step) == int(js.step) == step + 1
        for w, t in zip(_leaves(js.m), tree_leaves(ps.m)):
            assert t.dtype == tdt and torch.equal(t, w)
        for w, t in zip(_leaves(js.v), tree_leaves(ps.v)):
            assert t.dtype == torch.float32 and torch.equal(t, w)
        for w, t in zip(_leaves(jp), tree_leaves(pp)):
            torch.testing.assert_close(t, w, rtol=1e-6, atol=1e-9)


def test_emit_compute_params_matches_jax():
    """The cast-out tree takes the dtypes of ``compute_params`` (bf16
    here, fp32 for the kept norm leaf) and equals a cast of the new
    params."""
    kw = dict(lr=1e-2, weight_decay=0.01, emit_compute_params=True)
    jopt = JaxAdam(m_dtype=jnp.bfloat16, **kw)
    popt = FusedAdam(m_dtype=torch.bfloat16, **kw)
    tree = _tree(1)
    jp = jax.tree.map(jnp.asarray, tree)
    pp = _torch_tree(tree)
    jc = {"dense": jax.tree.map(lambda a: a.astype(jnp.bfloat16),
                                jp["dense"]), "layers": jp["layers"]}
    pc = {"dense": {k: v.to(torch.bfloat16) for k, v in pp["dense"].items()},
          "layers": list(pp["layers"])}
    g = _tree(2)
    jp2, _, jc2 = jopt.step(jax.tree.map(jnp.asarray, g), jp, jopt.init(jp),
                            compute_params=jc)
    pp2, _, pc2 = popt.step(_torch_tree(g), pp, popt.init(pp),
                            compute_params=pc)
    for w, c, p, tmpl in zip(_leaves(jc2), tree_leaves(pc2),
                             tree_leaves(pp2), tree_leaves(pc)):
        assert c.dtype == tmpl.dtype
        assert torch.equal(c, p.to(tmpl.dtype))
        torch.testing.assert_close(c.float(), w.float(), rtol=2 ** -8,
                                   atol=1e-9)
    # without compute_params the emission is uniformly bf16
    _, _, plain = popt.step(_torch_tree(g), pp, popt.init(pp))
    assert all(t.dtype == torch.bfloat16 for t in tree_leaves(plain))


def test_zero_gradient_leaves_still_decay():
    """AdamW with a zero gradient: m = v = 0, so the update is lr * wd *
    p alone, as in JAX."""
    kw = dict(lr=1e-2, weight_decay=0.1)
    tree = _tree(3)
    zeros = jax.tree.map(np.zeros_like, tree)
    jopt, popt = JaxAdam(**kw), FusedAdam(**kw)
    jp = jax.tree.map(jnp.asarray, tree)
    pp = _torch_tree(tree)
    jp2, _ = jopt.step(jax.tree.map(jnp.asarray, zeros), jp, jopt.init(jp))
    pp2, _ = popt.step(_torch_tree(zeros), pp, popt.init(pp))
    for w, t, p0 in zip(_leaves(jp2), tree_leaves(pp2), tree_leaves(pp)):
        torch.testing.assert_close(t, w, rtol=1e-6, atol=1e-9)
        torch.testing.assert_close(t, p0 - 1e-2 * 0.1 * p0, rtol=1e-6,
                                   atol=1e-9)
        assert not torch.equal(t, p0)


def test_unported_options_raise():
    with pytest.raises(RuntimeError, match="AMSGrad"):
        FusedAdam(amsgrad=True, use_flat_kernel=True)
    with pytest.raises(ValueError, match="m_dtype"):
        FusedAdam(m_dtype=torch.float16)
    with pytest.raises(RuntimeError, match="AMSGrad"):
        FusedAdam(amsgrad=True)

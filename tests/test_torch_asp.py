"""Port parity of ``contrib/sparsity`` (ASP, 2:4 structured sparsity)
against the JAX package on the CPU: the ASP cases of the reference's
``tests/L0/run_contrib/test_groupbn_asp.py``, each also held to the JAX
functions on the same inputs (carried across as numpy).

The m4n2 masks equal JAX's bit for bit, along either axis, on fp32 and
bf16 weights with tied magnitudes (zeros, repeated values: the stable
double argsort keeps JAX's choice); the default axis is the contraction
dimension; the mask tree's predicate skips 1-D, small and embedding-like
leaves, and on the JAX package's BERT and GPT trees (``init_bert`` /
``init_gpt`` of the tiny configurations, carried across with
``params_from_jax``) it prunes the leaves JAX prunes with the same
masks (GPT's stacked layer leaves are 3-D: only its embeddings are 2-D,
and they are skipped); the wrapped optimizer keeps the pruned slots at
exactly zero over three steps, with the reference's FusedSGD (momentum
0.9), whose params are the JAX optimizer's bit for bit on the same
gradients, and with FusedAdam's flat path, within FusedAdam's tolerance
against JAX (1e-6 relative: the two flat Adams part by an ulp in a few
elements). This module imports no JAX at its top."""

import functools

import numpy as np
import pytest
import torch

from apex_tpu_torch.contrib.sparsity import (
    ASP, apply_masks, compute_sparse_masks, m4n2_1d_mask,
)
from apex_tpu_torch.models._convert import params_from_jax
from apex_tpu_torch.optimizers import FusedAdam, FusedSGD
from apex_tpu_torch.utils.tree import tree_flatten


def _t(a):
    a = np.array(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


@functools.lru_cache(maxsize=None)
def _tied(dtype):
    """(64, 32) weights with ties: whole zero groups, repeated values in
    a group, and bf16 rounding's ties."""
    import jax
    import jax.numpy as jnp
    w = np.array(jax.random.normal(jax.random.PRNGKey(3), (64, 32)))
    w[:8] = 0.0
    w[8:16, :4] = 0.5
    w[16:24] = np.round(w[16:24])
    w[24:32, 1::4] = -w[24:32, ::4]
    return np.asarray(jnp.asarray(w).astype(getattr(jnp, dtype)))


@pytest.mark.parametrize("axis", [0, -1])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_masks_match_jax_with_ties(dtype, axis):
    from apex_tpu.contrib.sparsity import m4n2_1d_mask as jmask

    w = _tied(dtype)
    want = np.asarray(jmask(w, axis=axis))
    got = m4n2_1d_mask(_t(w), axis=axis).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.sum() == w.size // 2


def test_m4n2_mask_pattern():
    w = torch.tensor([[0.1, -3.0, 2.0, 0.05] * 4,
                      [4.0, 3.0, -2.0, 1.0] * 4])
    m = m4n2_1d_mask(w, axis=-1).numpy()
    assert m.sum() == w.numel() // 2
    assert m.reshape(2, 4, 4).sum(-1).min() == 2
    np.testing.assert_array_equal(m[0, :4], [False, True, True, False])


def test_m4n2_default_axis_is_contraction_dim():
    w = torch.tensor([[0.1], [-3.0], [2.0], [0.05],
                      [4.0], [3.0], [-2.0], [1.0]])
    m = m4n2_1d_mask(w).numpy()
    np.testing.assert_array_equal(
        m[:, 0], [False, True, True, False, True, True, False, False])
    assert m.reshape(2, 4).sum(-1).tolist() == [2, 2]
    with pytest.raises(ValueError, match="divisible by 4"):
        m4n2_1d_mask(torch.ones(6, 16))


def test_mask_tree_predicate():
    params = {"w": torch.ones(16, 64), "b": torch.ones(64),
              "tiny": torch.ones(2, 4)}
    masks = compute_sparse_masks(params)
    assert int(masks["w"].sum()) == 16 * 32
    assert masks["b"] is True
    assert masks["tiny"] is True


def test_default_predicate_skips_embeddings():
    params = {"embed": {"word": {"embedding": torch.ones(128, 64)}},
              "decoder": {"w": torch.ones(128, 64)},
              "layers": [{"lookup": torch.ones(64, 64)}]}
    masks = compute_sparse_masks(params)
    assert masks["embed"]["word"]["embedding"] is True
    assert masks["layers"][0]["lookup"] is True
    assert int(masks["decoder"]["w"].sum()) == 128 * 32


@functools.lru_cache(maxsize=None)
def _jax_model_masks(name):
    """A tiny JAX model's params (numpy) and JAX's mask leaves (None for
    the sentinel)."""
    import jax

    from apex_tpu.contrib.sparsity import compute_sparse_masks as jmasks
    if name == "bert":
        from apex_tpu.models.bert import bert_tiny, init_bert
        params = init_bert(jax.random.PRNGKey(0), bert_tiny())
    else:
        from apex_tpu.models.gpt import gpt_tiny, init_gpt
        params = init_gpt(jax.random.PRNGKey(0), gpt_tiny())
    leaves = jax.tree_util.tree_leaves(jmasks(params))
    return (jax.tree.map(np.asarray, params),
            [None if m is True else np.asarray(m) for m in leaves])


@pytest.mark.parametrize("name", ["bert", "gpt"])
def test_predicate_on_model_trees_matches_jax(name):
    """The port's masks of the port's tree: the leaves JAX prunes, with
    JAX's masks, in JAX's leaf order; every embedding left whole."""
    params_np, want = _jax_model_masks(name)
    params = params_from_jax(params_np, "cpu")
    masks = compute_sparse_masks(params)
    got, _ = tree_flatten(masks)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if w is None:
            assert g is True
        else:
            np.testing.assert_array_equal(g.numpy(), w)
    paths = []

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (k,))
        elif isinstance(node, list):
            for i, v in enumerate(node):
                walk(v, path + (i,))
        else:
            paths.append(("/".join(map(str, path)), node))

    walk(masks, ())
    # GPT's layer leaves are stacked (L, in, out): nothing 2-D to prune
    # but its embeddings, in JAX as here
    assert any(m is not True for _, m in paths) == (name == "bert")
    assert all(m is True for p, m in paths if "embed" in p.lower())


@functools.lru_cache(maxsize=None)
def _jax_wrapped(opt_name):
    """The reference's wrapped-optimizer run in JAX: params, masks and
    grads as numpy, and the params after each of three steps."""
    import jax

    from apex_tpu.contrib.sparsity import ASP as JASP
    from apex_tpu.contrib.sparsity import apply_masks as japply
    from apex_tpu.optimizers import FusedAdam as JAdam
    from apex_tpu.optimizers import FusedSGD as JSGD

    asp = JASP()
    params = {"w": jax.random.normal(jax.random.PRNGKey(0), (16, 64))}
    masks = asp.compute_sparse_masks(params)
    params = japply(params, masks)
    opt = JSGD(lr=0.1, momentum=0.9) if opt_name == "sgd" else JAdam(
        lr=1e-2, weight_decay=0.01, use_flat_kernel=True)
    state = opt.init(params)
    step = asp.wrap_optimizer(opt, masks)
    grads, outs = [], []
    for i in range(3):
        g = {"w": jax.random.normal(jax.random.PRNGKey(i), (16, 64))}
        params, state = step(g, params, state)
        grads.append(np.asarray(g["w"]))
        outs.append(np.asarray(params["w"]))
    return (np.asarray(jax.random.normal(jax.random.PRNGKey(0), (16, 64))),
            np.asarray(masks["w"]), grads, outs)


@pytest.mark.parametrize("opt_name", ["sgd", "adam_flat"])
def test_wrapped_optimizer_keeps_sparsity(opt_name):
    w0, jmask, grads, want = _jax_wrapped(opt_name)
    asp = ASP()
    params = {"w": _t(w0)}
    masks = asp.compute_sparse_masks(params)
    np.testing.assert_array_equal(masks["w"].numpy(), jmask)
    params = apply_masks(params, masks)
    opt = FusedSGD(lr=0.1, momentum=0.9) if opt_name == "sgd" else \
        FusedAdam(lr=1e-2, weight_decay=0.01, use_flat_kernel=True)
    state = opt.init(params)
    step = asp.wrap_optimizer(opt, masks)
    for g, w in zip(grads, want):
        params, state = step({"w": _t(g)}, params, state)
        if opt_name == "sgd":
            np.testing.assert_array_equal(params["w"].numpy(), w)
        else:   # FusedAdam's tolerance against JAX's (test_torch_fused_adam)
            np.testing.assert_allclose(params["w"].numpy(), w, rtol=1e-6,
                                       atol=1e-9)
    p = params["w"].numpy()
    assert (p[~masks["w"].numpy()] == 0).all()
    assert (p != 0).sum() == p.size // 2

"""Port parity for the public names the port lacked against the
reference (``ROADMAP.md`` queue C, C2): each against its JAX function
on the same inputs, on the CPU. Exact where the reference is (casts,
enums, integer helpers, zeros); the convolution and the models'
``compute_dtype`` paths within fp32 sum-order limits (1e-5) or, in
bf16, the bf16 limits of the model tests (5e-2)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu import amp as jax_amp
from apex_tpu.amp import properties as jax_props
from apex_tpu.models import bert as jax_bert
from apex_tpu.models import gpt as jax_gpt
from apex_tpu.models import layers as jax_layers
from apex_tpu.optimizers import _common as jax_common
from apex_tpu.transformer import enums as jax_enums
from apex_tpu.utils import math as jax_math
from apex_tpu_torch import amp as port_amp
from apex_tpu_torch.amp import properties as port_props
from apex_tpu_torch.models import bert as port_bert
from apex_tpu_torch.models import gpt as port_gpt
from apex_tpu_torch.models import layers as port_layers
from apex_tpu_torch.models._convert import params_from_jax
from apex_tpu_torch.optimizers import _common as port_common
from apex_tpu_torch.transformer import enums as port_enums
from apex_tpu_torch.utils import math as port_math


def _dtype_name(d):
    return None if d is None else str(d).replace("torch.", "").split(".")[-1]


@pytest.mark.parametrize("level", ["O0", "O1", "O2", "O3"])
def test_opt_level_classes_match_jax(level):
    want = getattr(jax_props, level)()(jax_props.Properties())
    got = getattr(port_props, level)()(port_props.Properties())
    assert type(port_props.opt_levels[level]) is getattr(port_props, level)
    assert getattr(port_props, level).brief.split(":")[0] == level
    for f in dataclasses.fields(want):
        w, g = getattr(want, f.name), getattr(got, f.name)
        if f.name == "cast_model_type":
            assert _dtype_name(g) == (None if w is None
                                      else np.dtype(w).name)
        else:
            assert g == w, f.name
    assert got.half_dtype is got.cast_model_type


def test_loss_scale_reads_the_state():
    s = port_amp.LossScaler("dynamic", init_scale=8.0)
    st = s.init_state("cpu")
    assert float(s.loss_scale(st)) == float(jax_amp.LossScaler(
        "dynamic", init_scale=8.0).loss_scale(jax_amp.LossScaler(
            "dynamic", init_scale=8.0).init_state()))


def test_master_params_and_model_params_from_master_match_jax():
    rng = np.random.RandomState(0)
    tree = {"w": rng.randn(3, 4).astype(np.float32),
            "layernorm": {"weight": rng.randn(4).astype(np.float32)},
            "blocks": [rng.randn(2).astype(np.float32)]}
    jh = jax_amp.initialize("O2", verbosity=0)
    ph = port_amp.initialize("O2", verbosity=0)
    jlike = jh.cast_model(jax.tree.map(jnp.asarray, tree))
    plike = ph.cast_model(params_from_jax(tree, "cpu"))
    jm = jax_amp.master_params(jlike)
    pm = port_amp.master_params(plike)
    jback = jax_amp.model_params_from_master(jm, jlike)
    pback = port_amp.model_params_from_master(pm, plike)
    for want, got in ((jm, pm), (jback, pback)):
        for w, g in zip(jax.tree.leaves(want), jax.tree.leaves(
                {"blocks": got["blocks"], "layernorm": got["layernorm"],
                 "w": got["w"]})):
            assert np.dtype(w.dtype).name == _dtype_name(g.dtype)
            np.testing.assert_array_equal(
                np.asarray(w).astype(np.float32), g.float().numpy())
    pre = {"w": torch.full((3, 4), 7.0, dtype=torch.bfloat16),
           "layernorm": {"weight": torch.zeros(4, dtype=torch.bfloat16)},
           "blocks": [torch.ones(2, dtype=torch.bfloat16)]}
    got = port_amp.model_params_from_master(pm, plike, precast=pre)
    assert got["w"] is pre["w"] and got["blocks"][0] is pre["blocks"][0]
    # the fp32 norm leaf does not match the bf16 emission: cast from master
    assert got["layernorm"]["weight"].dtype == torch.float32


@pytest.mark.parametrize("name", ["LayerType", "AttnType", "AttnMaskType",
                                  "ModelType"])
def test_enums_match_jax(name):
    want, got = getattr(jax_enums, name), getattr(port_enums, name)
    assert [(m.name, m.value) for m in got] == [(m.name, m.value)
                                                for m in want]


@pytest.mark.parametrize("a,b", [(12, 4), (12, 5)])
def test_divide_and_ensure_divisibility_match_jax(a, b):
    if a % b:
        for mod in (jax_math, port_math):
            with pytest.raises(ValueError, match=f"{a} is not divisible"):
                mod.divide(a, b)
    else:
        assert port_math.divide(a, b) == jax_math.divide(a, b) == 3
        port_math.ensure_divisibility(a, b)


def test_tree_zeros_f32_matches_jax():
    tree = {"a": np.ones((2, 3), np.float32), "b": [np.ones(4, np.float32)]}
    want = jax_common.tree_zeros_f32(tree)
    got = port_common.tree_zeros_f32(params_from_jax(tree, "cpu"))
    assert got["a"].dtype == torch.float32 and got["a"].shape == (2, 3)
    assert float(got["b"][0].abs().sum()) == 0.0
    assert want["b"][0].shape == tuple(got["b"][0].shape)


def test_embedding_casts_the_table_first():
    table = np.random.RandomState(1).randn(10, 8).astype(np.float32)
    ids = np.array([[1, 9, 3]], np.int32)
    want = jax_layers.embedding({"embedding": jnp.asarray(table)},
                                jnp.asarray(ids), jnp.bfloat16)
    got = port_layers.embedding({"embedding": torch.from_numpy(table)},
                                torch.from_numpy(ids).long(),
                                torch.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want).astype(np.float32))


@pytest.mark.parametrize("padding", ["SAME", "VALID", ((1, 0), (2, 1))])
@pytest.mark.parametrize("stride", [1, 2])
def test_conv_padding_matches_jax(padding, stride):
    rng = np.random.RandomState(2)
    x = rng.randn(2, 9, 10, 3).astype(np.float32)
    k = rng.randn(3, 3, 3, 4).astype(np.float32)
    want = jax_layers.conv({"kernel": jnp.asarray(k)}, jnp.asarray(x),
                           stride, padding)
    got = port_layers.conv({"kernel": torch.from_numpy(k)},
                           torch.from_numpy(x), stride, padding)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_apply_bert_compute_dtype_matches_jax():
    cfg = jax_bert.bert_tiny()
    params = jax_bert.init_bert(jax.random.PRNGKey(1), cfg)
    ids = np.random.RandomState(0).randint(0, cfg.vocab_size, (2, 16))
    want = jax_bert.apply_bert(params, cfg, jnp.asarray(ids, jnp.int32),
                               compute_dtype=jnp.bfloat16)
    got = port_bert.apply_bert(
        params_from_jax(jax.tree.map(np.asarray, params), "cpu"),
        port_bert.bert_tiny(), torch.from_numpy(ids).long(),
        compute_dtype=torch.bfloat16)
    assert got["hidden"].dtype == torch.bfloat16
    np.testing.assert_allclose(
        got["hidden"].float().numpy(),
        np.asarray(want["hidden"]).astype(np.float32), rtol=5e-2, atol=5e-2)


def test_apply_gpt_compute_dtype_matches_jax():
    cfg = jax_gpt.gpt_tiny()
    params = jax_gpt.init_gpt(jax.random.PRNGKey(0), cfg)
    ids = np.random.RandomState(0).randint(0, cfg.vocab_size, (1, 12))
    want = jax_gpt.apply_gpt_unsharded(params, cfg,
                                       jnp.asarray(ids, jnp.int32),
                                       compute_dtype=jnp.float32)
    got = port_gpt.apply_gpt_unsharded(
        port_gpt.params_from_jax(jax.tree.map(np.asarray, params), "cpu"),
        port_gpt.gpt_tiny(), torch.from_numpy(ids).long(),
        compute_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)

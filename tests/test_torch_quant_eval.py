"""Port parity of the L1 int8 eval gate (``tests/L1/test_quant_eval_parity.py``)
against the JAX package on the CPU.

The reference's trained model: ``gpt_tiny`` with RoPE and no dropout,
``FusedAdam(lr=1e-3)`` for 20 steps on its fixed batch, trained by the
JAX package in a module fixture and carried across with
``params_from_jax``. The teacher-forced NLL at every decode position of
its eval sequence (prompt 8, 20 tokens) runs through the port's serving
paths: the dense prefill and decode steps (``make_prefill_fn`` /
``make_decode_fn``) and the paged engine (``PagedDecodeEngine``, pages of
8), for ``w8_dense``, ``w8_paged``, ``w8_kv8`` and ``kv8_only``
(``quantize_params``; an int8 page pool). Held: each variant within the
reference's ``QUANT_EVAL_RTOL`` (0.02) of the port's fp32 rows and not
equal to them; the fp32 rows clearly under the uniform floor and within
``FP32_RTOL`` of the JAX package's fp32 rows. Measured on this CPU: the
fp32 rows 8.3e-08 from JAX's (mean NLL 5.70, the floor ln 512 - 0.5 =
5.74), the variants' worst positions 4.4e-03 (w8, dense and paged),
2.8e-03 (w8 over the int8 pool), 5.8e-04 (the int8 pool alone). The
reference marks its file slow; this one takes a few seconds past the JAX
training."""

import dataclasses
import importlib.util
import os

import jax
import numpy as np
import pytest
import torch

from apex_tpu.models import gpt_loss_unsharded as jax_gpt_loss
from apex_tpu.models.gpt import gpt_tiny as jax_gpt_tiny
from apex_tpu.models.gpt import init_gpt as jax_init_gpt
from apex_tpu.optimizers import FusedAdam as JaxFusedAdam
from apex_tpu_torch.models import gpt as port_gpt
from apex_tpu_torch.models._convert import params_from_jax
from apex_tpu_torch.quant import quantize_params
from apex_tpu_torch.serving import (
    PagedDecodeEngine, init_cache, make_decode_fn, make_prefill_fn,
)

TRAIN_STEPS = 20
S_TOTAL, PROMPT, S_MAX = 20, 8, 32
QUANT_EVAL_RTOL = 0.02
FP32_RTOL = 1e-5


def _reference():
    path = os.path.join(os.path.dirname(__file__), "L1",
                        "test_quant_eval_parity.py")
    spec = importlib.util.spec_from_file_location("_l1_quant_eval", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF = _reference()


@pytest.fixture(scope="module", autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def trained():
    """The reference fixture's recipe in JAX: (JAX cfg, trained params,
    eval sequence)."""
    cfg = dataclasses.replace(jax_gpt_tiny(), hidden_dropout=0.0,
                              use_rope=True)
    params = jax_init_gpt(jax.random.PRNGKey(0), cfg)
    opt = JaxFusedAdam(lr=1e-3, weight_decay=0.0)
    opt_state = opt.init(params)

    @jax.jit
    def step(params, opt_state, ids):
        loss, grads = jax.value_and_grad(
            lambda p: jax_gpt_loss(p, cfg, ids, ids))(params)
        params, opt_state = opt.step(grads, params, opt_state)
        return params, opt_state, loss

    ids = jax.random.randint(jax.random.PRNGKey(20_000), (4, 32), 0,
                             cfg.vocab_size)
    for _ in range(TRAIN_STEPS):
        params, opt_state, _ = step(params, opt_state, ids)
    return cfg, params, ids[:1, :S_TOTAL]


@pytest.fixture(scope="module")
def port(trained):
    """(port cfg, carried fp32 params, eval sequence as a list)."""
    _, params, seq = trained
    cfg = dataclasses.replace(port_gpt.gpt_tiny(), hidden_dropout=0.0,
                              use_rope=True)
    return (cfg, params_from_jax(jax.tree.map(np.asarray, params), "cpu"),
            [int(t) for t in np.asarray(seq[0])])


def _rows(cfg, params, seq, *, paged, cache_dtype, quantized):
    """The reference's ``_teacher_forced_rows`` on the port."""
    rows = []
    with torch.inference_mode():
        if paged:
            eng = PagedDecodeEngine(params, cfg, num_slots=2, max_len=S_MAX,
                                    num_pages=14, page_size=8,
                                    cache_dtype=cache_dtype,
                                    buckets=(8, 16, 32), device="cpu")
            rows.append(eng.prefill(0, seq[:PROMPT])[0])
            for t in range(PROMPT, S_TOTAL):
                assert eng.prepare_decode({0: t}) == []
                rows.append(eng.decode([seq[t], 0], [True, False])[0])
            return torch.stack(rows)
        prefill = make_prefill_fn(cfg, quantized=quantized)
        decode = make_decode_fn(cfg, quantized=quantized)
        cache = init_cache(cfg, 2, S_MAX, torch.float32, "cpu")
        cache, logits = prefill(params, cache,
                                torch.tensor([seq[:PROMPT]]),
                                torch.ones((PROMPT,), dtype=torch.int32), 0)
        rows.append(logits[0])
        for t in range(PROMPT, S_TOTAL):
            cache, logits = decode(params, cache, torch.tensor([seq[t], 0]),
                                   torch.tensor([True, False]))
            rows.append(logits[0])
        return torch.stack(rows)


def _nll(cfg, params, seq, **kw):
    """Row t scores seq[t + 1] (the last row has no target)."""
    rows = _rows(cfg, params, seq, **kw)[:-1].double()
    tgt = torch.tensor(seq[PROMPT:])
    lse = torch.logsumexp(rows, dim=-1)
    return (lse - rows[torch.arange(len(tgt)), tgt]).numpy()


@pytest.fixture(scope="module")
def golden_nll(port, trained):
    cfg, params, seq = port
    curve = _nll(cfg, params, seq, paged=False, cache_dtype=None,
                 quantized=False)
    assert np.all(np.isfinite(curve))
    assert curve.mean() < np.log(cfg.vocab_size) - 0.5, curve
    jcfg, jparams, jseq = trained
    want = REF._nll_curve(jcfg, jparams, jseq, paged=False, cache_dtype=None,
                          quantized=False)
    np.testing.assert_allclose(curve, want, rtol=FP32_RTOL)
    return curve


def test_fp32_rows_meet_jax(golden_nll):
    """The fp32 rows: under the uniform floor, JAX's within FP32_RTOL
    (the fixture holds both)."""
    assert golden_nll.shape == (S_TOTAL - PROMPT,)


@pytest.mark.parametrize("variant", ["w8_dense", "w8_paged",
                                     "w8_kv8", "kv8_only"])
def test_quant_eval_curve_tracks_fp32(port, golden_nll, variant):
    cfg, params, seq = port
    qp = quantize_params(params)
    kw = {"w8_dense": dict(params=qp, paged=False, cache_dtype=None,
                           quantized=True),
          "w8_paged": dict(params=qp, paged=True, cache_dtype=torch.float32,
                           quantized=True),
          "w8_kv8": dict(params=qp, paged=True, cache_dtype=torch.int8,
                         quantized=True),
          "kv8_only": dict(params=params, paged=True,
                           cache_dtype=torch.int8, quantized=False)}[variant]
    curve = _nll(cfg, kw.pop("params"), seq, **kw)
    assert np.all(np.isfinite(curve))
    np.testing.assert_allclose(curve, golden_nll, rtol=QUANT_EVAL_RTOL)
    assert np.any(curve != golden_nll)

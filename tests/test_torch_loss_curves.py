"""Port parity of the L1 loss curves (``tests/L1/test_loss_curve_parity.py``)
against the JAX package on the CPU.

BERT (``bert_tiny``, 20 steps, ``FusedAdam(lr=5e-4, weight_decay=0.01)``,
batch ``randint(PRNGKey(10_000 + i), (4, 32))``) through the port's
``examples/bert/train.py`` step (``BertTrainStep``: ``cast_model`` with
``precast``, ``autocast``, ``Amp.value_and_grad``, the optimizer step
gated on ``found_inf``), and GPT (``gpt_tiny`` on one fixed batch)
through ``examples/gpt/train.py``'s ``GPTTrainStep``. The weights are the
JAX package's ``init_bert`` / ``init_gpt(PRNGKey(0))``, carried across by
``params_from_jax``; the batches come from ``utils.prng``, bit for bit
``jax.random``'s. The JAX curves are the reference module's own
functions (``bert_curve``, ``gpt_curve``).

Held, as the reference holds its curves: the fp32 golden converges;
every amp level and both reduced-precision optimizer-state modes track
the fp32 golden within ``rtol=0.05`` (the port's golden and the JAX
package's), converge, and differ from it; the GPT smoke drops by more
than 0.5 and bf16 over fp32 masters tracks fp32. Held besides, against
JAX's curve at the same settings: the fp32 curves within ``FP32_RTOL``
(measured 1.4e-07 BERT O0, 5.2e-07 GPT, on this CPU) and the
reduced-precision ones within ``AMP_RTOL`` (measured 7.2e-05 BERT O1,
1.1e-04 GPT bf16)."""

import functools
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.models import bert_tiny as jax_bert_tiny
from apex_tpu.models import gpt_tiny as jax_gpt_tiny
from apex_tpu.models import init_bert as jax_init_bert
from apex_tpu.models import init_gpt as jax_init_gpt
from apex_tpu_torch import amp
from apex_tpu_torch.examples.bert.train import BertTrainStep
from apex_tpu_torch.examples.gpt.train import GPTTrainStep
from apex_tpu_torch.models import bert as port_bert
from apex_tpu_torch.models import gpt as port_gpt
from apex_tpu_torch.models._convert import params_from_jax
from apex_tpu_torch.optimizers import FusedAdam
from apex_tpu_torch.utils import prng

STEPS = 20
#: the reference's tolerance for an amp curve against the fp32 golden
RTOL = 0.05
#: port against JAX at the same settings: fp32, and bf16 compute
FP32_RTOL = 1e-5
AMP_RTOL = 1e-3


def _reference():
    path = os.path.join(os.path.dirname(__file__), "L1",
                        "test_loss_curve_parity.py")
    spec = importlib.util.spec_from_file_location("_l1_loss_curves", path)
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


@functools.lru_cache(maxsize=None)
def _jax_weights(model: str):
    if model == "bert":
        tree = jax_init_bert(jax.random.PRNGKey(0), jax_bert_tiny())
    else:
        tree = jax_init_gpt(jax.random.PRNGKey(0), jax_gpt_tiny())
    return jax.tree.map(np.asarray, tree)


def _bert_batch(i: int, vocab: int):
    ids = prng.randint(prng.PRNGKey(10_000 + i), (4, 32), 0, vocab,
                       device="cpu").long()
    return ids, torch.ones(ids.shape, dtype=torch.int32)


@functools.lru_cache(maxsize=None)
def port_bert_curve(opt_level, loss_scale="dynamic", m_dtype="float32",
                    emit_compute=False):
    """The reference's ``bert_curve`` on the port."""
    cfg = port_bert.bert_tiny()
    h = amp.initialize(opt_level, loss_scale=loss_scale, verbosity=0)
    params = params_from_jax(_jax_weights("bert"), "cpu")
    opt = FusedAdam(lr=5e-4, weight_decay=0.01,
                    m_dtype=getattr(torch, m_dtype),
                    emit_compute_params=emit_compute)
    step = BertTrainStep(cfg, h, opt)
    state = [params, opt.init(params), h.init_state("cpu")]
    if emit_compute:
        state.append(h.cast_model(params))
    losses = []
    for i in range(STEPS):
        *state, loss = step(*state, *_bert_batch(i, cfg.vocab_size))
        losses.append(float(loss))
    return np.array(losses)


@functools.lru_cache(maxsize=None)
def jax_bert_curve(opt_level, loss_scale="dynamic", m_dtype="float32",
                   emit_compute=False):
    return REF.bert_curve(opt_level, loss_scale=loss_scale,
                          m_dtype=getattr(jnp, m_dtype),
                          emit_compute=emit_compute)


@functools.lru_cache(maxsize=None)
def port_gpt_curve(compute_dtype=None, lr=5e-4, weight_decay=0.01,
                   batch_key=30_000):
    """The reference's ``gpt_curve`` on the port."""
    cfg = port_gpt.gpt_tiny()
    params = params_from_jax(_jax_weights("gpt"), "cpu")
    opt = FusedAdam(lr=lr, weight_decay=weight_decay)
    opt_state = opt.init(params)
    step = GPTTrainStep(cfg, opt, None if compute_dtype is None
                        else getattr(torch, compute_dtype))
    ids = prng.randint(prng.PRNGKey(batch_key), (4, 32), 0, cfg.vocab_size,
                       device="cpu").long()
    losses = []
    for _ in range(STEPS):
        params, opt_state, loss = step(params, opt_state, ids, ids)
        losses.append(float(loss))
    return np.array(losses)


@functools.lru_cache(maxsize=None)
def jax_gpt_curve(compute_dtype=None, **kw):
    return REF.gpt_curve(None if compute_dtype is None
                         else getattr(jnp, compute_dtype), **kw)


def _golden():
    return port_bert_curve("O0", loss_scale=1.0)


def test_batches_are_the_jax_bits():
    """``utils.prng`` draws the reference's batches bit for bit."""
    vocab = port_bert.bert_tiny().vocab_size
    for i in (0, STEPS - 1):
        want = jax.random.randint(jax.random.PRNGKey(10_000 + i), (4, 32),
                                  0, vocab)
        assert np.array_equal(_bert_batch(i, vocab)[0].numpy(),
                              np.asarray(want))
    for key in (20_000, 30_000):
        want = jax.random.randint(jax.random.PRNGKey(key), (4, 32), 0,
                                  port_gpt.gpt_tiny().vocab_size)
        got = prng.randint(prng.PRNGKey(key), (4, 32), 0,
                           port_gpt.gpt_tiny().vocab_size, device="cpu")
        assert np.array_equal(got.numpy(), np.asarray(want))


def test_golden_run_converges_and_meets_jax():
    golden = _golden()
    assert np.all(np.isfinite(golden))
    assert golden[-1] < golden[0] - 0.1, golden
    np.testing.assert_allclose(golden, jax_bert_curve("O0", loss_scale=1.0),
                               rtol=FP32_RTOL)


def _tracks(curve, jax_same):
    """The reference's contract against the port's golden and the JAX
    golden, and JAX's curve at the same settings."""
    golden = _golden()
    assert np.all(np.isfinite(curve))
    np.testing.assert_allclose(curve, golden, rtol=RTOL)
    np.testing.assert_allclose(curve, jax_bert_curve("O0", loss_scale=1.0),
                               rtol=RTOL)
    assert curve[-1] < curve[0] - 0.1
    assert np.any(curve != golden)
    np.testing.assert_allclose(curve, jax_same, rtol=AMP_RTOL)


@pytest.mark.parametrize("opt_level", ["O1", "O2", "O3"])
def test_amp_curve_tracks_fp32(opt_level):
    _tracks(port_bert_curve(opt_level), jax_bert_curve(opt_level))


def test_state_dtype_bf16_m_curve_tracks_fp32():
    _tracks(port_bert_curve("O2", m_dtype="bfloat16"),
            jax_bert_curve("O2", m_dtype="bfloat16"))


def test_state_dtype_castout_curve_tracks_fp32():
    _tracks(port_bert_curve("O2", m_dtype="bfloat16", emit_compute=True),
            jax_bert_curve("O2", m_dtype="bfloat16", emit_compute=True))


def test_gpt_converges():
    """The fixed-batch overfit: a drop of more than 0.5, and JAX's curve."""
    kw = dict(lr=1e-3, weight_decay=0.0, batch_key=20_000)
    losses = port_gpt_curve(None, **kw)
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] - 0.5, losses
    np.testing.assert_allclose(losses, jax_gpt_curve(None, **kw),
                               rtol=FP32_RTOL)


def test_gpt_bf16_curve_tracks_fp32():
    """bf16 compute over fp32 masters tracks fp32; each curve meets
    JAX's."""
    fp32 = port_gpt_curve(None)
    bf16 = port_gpt_curve("bfloat16")
    assert np.all(np.isfinite(bf16))
    np.testing.assert_allclose(bf16, fp32, rtol=RTOL)
    assert bf16[-1] < bf16[0] - 0.1
    assert np.any(bf16 != fp32)
    np.testing.assert_allclose(fp32, jax_gpt_curve(None), rtol=FP32_RTOL)
    np.testing.assert_allclose(bf16, jax_gpt_curve("bfloat16"),
                               rtol=AMP_RTOL)

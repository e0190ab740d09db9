"""Port parity of the L1 ImageNet cross product
(``tests/L1/test_imagenet_cross_product.py``) against the JAX package on
the CPU.

ResNet depth 10, 10 classes, one fixed batch of 8 images at 32 x 32
(``normal`` and ``randint`` on ``PRNGKey(7_000)`` through ``utils.prng``:
the labels are jax's bit for bit, the images within
``prng.normal_limit``), 8 steps of the reference's step: ``cast_model``,
``cast_input``, ``Amp.value_and_grad(has_aux=True)`` over the port's
``apply_resnet`` and ``cross_entropy_loss``, ``FusedSGD(lr=0.01,
momentum=0.9, weight_decay=1e-4)`` gated on ``found_inf``, and
``apply_if_finite`` on the BatchNorm statistics; the weights are the JAX
package's ``init_resnet(PRNGKey(0))`` carried across. As the reference's
recipe, no ``autocast`` block: O1 touches no op of this model, and its
curve is the fp32 one.

Held, as the reference holds them: the fp32 golden converges, and each
of the five (opt level, keep_batchnorm_fp32, loss scale) cases tracks it
at ``rtol`` 0.10 (0.15 at O3) and ``atol`` 0.02, converges, and (but O1)
differs from it; each also meets JAX's curve at the same settings at the
same tolerances, and the fp32 golden meets JAX's within ``FP32_RTOL`` /
``FP32_ATOL`` (measured 1.9e-05 relative, 2.1e-06 absolute, on this
CPU)."""

import functools
import importlib.util
import os

import jax
import numpy as np
import pytest
import torch

from apex_tpu.models import init_resnet as jax_init_resnet
from apex_tpu_torch import amp
from apex_tpu_torch.models._convert import params_from_jax
from apex_tpu_torch.models.resnet import apply_resnet, cross_entropy_loss
from apex_tpu_torch.optimizers import FusedSGD
from apex_tpu_torch.utils import prng

STEPS = 8
DEPTH = 10
CLASSES = 10
BATCH, IMG = 8, 32
FP32_RTOL, FP32_ATOL = 1e-4, 1e-5
CASES = [("O1", None, "dynamic"), ("O2", True, "dynamic"),
         ("O2", False, 128.0), ("O3", True, 128.0), ("O3", False, "dynamic")]


def _reference():
    path = os.path.join(os.path.dirname(__file__), "L1",
                        "test_imagenet_cross_product.py")
    spec = importlib.util.spec_from_file_location("_l1_imagenet", path)
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
def _jax_weights():
    return jax.tree.map(np.asarray,
                        jax_init_resnet(jax.random.PRNGKey(0), DEPTH,
                                        CLASSES))


def _batch():
    key = prng.PRNGKey(7_000)
    images = prng.normal(key, (BATCH, IMG, IMG, 3), device="cpu")
    labels = prng.randint(key, (BATCH,), 0, CLASSES, device="cpu")
    return images, labels.long()


@functools.lru_cache(maxsize=None)
def port_resnet_curve(opt_level, kbn=None, loss_scale="dynamic"):
    """The reference's ``resnet_curve`` on the port."""
    h = amp.initialize(opt_level, keep_batchnorm_fp32=kbn,
                       loss_scale=loss_scale, verbosity=0)
    params, stats = (params_from_jax(t, "cpu") for t in _jax_weights())
    opt = FusedSGD(lr=0.01, momentum=0.9, weight_decay=1e-4)
    opt_state = opt.init(params)
    scaler_state = h.init_state("cpu")

    def loss_fn(p, stats, images, labels):
        logits, new_stats = apply_resnet(p, stats, images, DEPTH, train=True)
        return cross_entropy_loss(logits, labels), new_stats

    value_and_grad = h.value_and_grad(loss_fn, has_aux=True)
    images, labels = _batch()
    losses = []
    for _ in range(STEPS):
        p = h.cast_model(params)
        (loss, new_stats), grads, found_inf, scaler_state = value_and_grad(
            p, scaler_state, stats, h.cast_input(images), labels)
        params, opt_state = opt.step(grads, params, opt_state,
                                     found_inf=found_inf)
        stats = amp.apply_if_finite(new_stats, stats, found_inf)
        losses.append(float(loss))
    return np.array(losses)


@functools.lru_cache(maxsize=None)
def jax_resnet_curve(opt_level, kbn=None, loss_scale="dynamic"):
    return REF.resnet_curve(opt_level, kbn=kbn, loss_scale=loss_scale)


def test_batch_labels_are_the_jax_bits():
    key = jax.random.PRNGKey(7_000)
    images, labels = _batch()
    assert np.array_equal(labels.numpy(), np.asarray(
        jax.random.randint(key, (BATCH,), 0, CLASSES)))
    want = np.array(jax.random.normal(key, (BATCH, IMG, IMG, 3)))
    assert np.all(np.abs(images.numpy() - want)
                  <= prng.normal_limit(torch.from_numpy(want)).numpy())


def test_golden_resnet_converges_and_meets_jax():
    golden = port_resnet_curve("O0", loss_scale=1.0)
    assert np.all(np.isfinite(golden))
    assert golden[-1] < golden[0] - 0.1, golden
    np.testing.assert_allclose(golden, jax_resnet_curve("O0", loss_scale=1.0),
                               rtol=FP32_RTOL, atol=FP32_ATOL)


@pytest.mark.parametrize("opt_level,kbn,loss_scale", CASES)
def test_resnet_amp_curve_tracks_fp32(opt_level, kbn, loss_scale):
    golden = port_resnet_curve("O0", loss_scale=1.0)
    curve = port_resnet_curve(opt_level, kbn=kbn, loss_scale=loss_scale)
    assert np.all(np.isfinite(curve))
    rtol = 0.15 if opt_level == "O3" else 0.10
    np.testing.assert_allclose(curve, golden, rtol=rtol, atol=0.02)
    assert curve[-1] < curve[0] - 0.1
    if opt_level != "O1":
        assert np.any(curve != golden)
    np.testing.assert_allclose(
        curve, jax_resnet_curve(opt_level, kbn=kbn, loss_scale=loss_scale),
        rtol=rtol, atol=0.02)

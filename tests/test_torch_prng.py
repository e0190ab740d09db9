"""Port parity: ``apex_tpu_torch.utils.prng`` against the installed
``jax.random`` on the CPU (the plain int64 version of the threefry
kernel; ``tests/test_torch_kernels_cuda.py`` and ``chip_smoke.py`` hold
the kernel to it on the card).

Limits: keys, bits, uniforms, Bernoulli draws, ``randint`` and the fused
dropout equal jax's exactly. ``gumbel`` and ``normal`` go through
``log`` and ``erfinv``, which torch and XLA round differently: each is
held per element to its module's limit (``prng.gumbel_limit``,
``prng.normal_limit``), and ``categorical`` to the same index except
where a row's two best perturbed scores lie within twice the gumbel
limit of each other (none did at these seeds; the test prints the
smallest gap it met)."""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from apex_tpu.models import bert as jax_bert
from apex_tpu_torch.utils import prng

JR = jax.random
SEEDS = [0, 1, 42, 2 ** 31 - 1, -1, 2 ** 32 + 5]
SHAPES = [(1,), (3,), (7,), (1001,), (4, 5), (2, 3, 7)]


def _key(seed):
    return JR.PRNGKey(seed), prng.PRNGKey(seed)


def test_partitionable_flag_is_on():
    """The port reproduces jax with jax_threefry_partitionable=True, the
    installed default; this fails if the default changes."""
    assert jax.config.jax_threefry_partitionable is True


def test_known_answers():
    """Random123's threefry2x32-20 known answer is split(PRNGKey(0))[0]."""
    k = prng.PRNGKey(0)
    assert k.tolist() == [0, 0]
    assert prng.split(k, 2).tolist() == [[0x6B200159, 0x99BA4EFE],
                                         [0x375F238F, 0xCDDB151D]]
    assert prng.fold_in(k, 1).tolist() == [0x375F238F, 0xCDDB151D]
    want = [0xF29A4FA7, 0xFA843692, 0x55110E28, 0x77FAA835]
    assert prng.bits(k, (4,), device="cpu").tolist() == want
    assert list(prng.host_bits(k, 4)) == want


@pytest.mark.parametrize("seed", SEEDS)
def test_prngkey(seed):
    kj, kt = _key(seed)
    np.testing.assert_array_equal(kt.numpy(), np.asarray(kj))


@pytest.mark.parametrize("shape", [2, (5,), (2, 3)])
def test_split(shape):
    kj, kt = _key(42)
    np.testing.assert_array_equal(prng.split(kt, shape).numpy(),
                                  np.asarray(JR.split(kj, shape)))


@pytest.mark.parametrize("data", [0, 7, 2 ** 32 - 1])
def test_fold_in(data):
    kj, kt = _key(42)
    np.testing.assert_array_equal(prng.fold_in(kt, data).numpy(),
                                  np.asarray(JR.fold_in(kj, data)))


@pytest.mark.parametrize("shape", SHAPES)
def test_bits(shape):
    kj, kt = _key(7)
    want = np.asarray(JR.bits(kj, shape)).astype(np.int64)
    np.testing.assert_array_equal(prng.bits(kt, shape, device="cpu").numpy(),
                                  want)
    assert prng.host_bits(kt, 5) == tuple(
        np.asarray(JR.bits(kj, (5,))).tolist())


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("lims", [(0.0, 1.0), (-2.5, 3.0)])
def test_uniform_bit_for_bit(shape, lims):
    kj, kt = _key(3)
    got = prng.uniform(kt, shape, minval=lims[0], maxval=lims[1],
                       device="cpu").numpy()
    want = np.asarray(JR.uniform(kj, shape, minval=lims[0],
                                 maxval=lims[1]))
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("p", [0.1, 0.5, 0.9])
def test_bernoulli(p):
    kj, kt = _key(11)
    got = prng.bernoulli(kt, p, (37, 11), device="cpu").numpy()
    np.testing.assert_array_equal(got, np.asarray(JR.bernoulli(kj, p,
                                                               (37, 11))))


@pytest.mark.parametrize("lims", [(0, 10), (-5, 50304), (3, 3), (9, 2),
                                  (7, 70000), (0, 2 ** 31 - 1),
                                  (-2 ** 31, 2 ** 31 - 1)])
def test_randint_exact(lims):
    kj, kt = _key(1000)
    got = prng.randint(kt, (64, 3), *lims, device="cpu")
    want = np.asarray(JR.randint(kj, (64, 3), *lims))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_gumbel_within_its_limit():
    kj, kt = _key(5)
    got = prng.gumbel(kt, (50304,), device="cpu").numpy()
    want = np.asarray(JR.gumbel(kj, (50304,)))
    share = np.abs(got - want) / prng.gumbel_limit(torch.tensor(want)).numpy()
    print(f"gumbel: {np.mean(got != want):.3f} of the values differ from "
          f"jax's, worst share of gumbel_limit {share.max():.3f}")
    assert share.max() <= 1.0


def test_normal_within_its_limit():
    kj, kt = _key(6)
    got = prng.normal(kt, (200000,), device="cpu").numpy()
    want = np.asarray(JR.normal(kj, (200000,)))
    share = np.abs(got - want) / prng.normal_limit(torch.tensor(want)).numpy()
    print(f"normal: worst share of normal_limit {share.max():.3f} "
          f"(max |z| {np.abs(want).max():.2f})")
    assert share.max() <= 1.0


def _top_gap(scores):
    """Each row's gap between its best and second-best score."""
    top2 = np.sort(scores, axis=-1)[:, -2:]
    return top2[:, 1] - top2[:, 0]


def _held_to_gumbel(got, want, scores, label):
    """Indices equal, or the row's two best scores inside twice the
    gumbel limit (a flip the error model allows)."""
    gap = _top_gap(scores)
    lim = 2 * prng.gumbel_limit(torch.tensor(scores.max(-1))).numpy()
    print(f"{label}: smallest top-two gap {gap.min():.3g} (limit "
          f"{lim.max():.3g}); {int(np.sum(got != want))} flips")
    assert np.all((got == want) | (gap <= lim))


@pytest.mark.parametrize("rows", [1, 16])
def test_categorical(rows):
    kj, kt = _key(9)
    logits = np.random.RandomState(rows).randn(rows, 1000).astype(
        np.float32) * 2
    got = prng.categorical(kt, torch.from_numpy(logits)).numpy()
    want = np.asarray(JR.categorical(kj, jnp.asarray(logits)))
    scores = np.asarray(JR.gumbel(kj, logits.shape)) + logits
    _held_to_gumbel(got, want, scores, "categorical")


def test_categorical_rows_is_vmapped_categorical():
    kj, kt = _key(12)
    keys = prng.split(kt, 8)
    logits = np.random.RandomState(0).randn(8, 50304).astype(np.float32)
    got = prng.categorical_rows(keys, torch.from_numpy(logits)).numpy()
    kjs = jnp.asarray(keys.numpy().astype(np.uint32))
    want = np.asarray(jax.vmap(JR.categorical)(kjs, jnp.asarray(logits)))
    g = np.asarray(jax.vmap(lambda k: JR.gumbel(k, (50304,)))(kjs))
    _held_to_gumbel(got, want, g + logits, "categorical_rows")


def _bf16(x):
    return torch.from_numpy(np.asarray(x).view(np.uint16)).view(
        torch.bfloat16)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_dropout_matches_the_jax_expression(dtype, rate):
    """prng.dropout against the JAX package's ``_maybe_dropout`` under
    jit (what its training step compiles: the division by 1 - rate
    becomes a multiply by its fp32 reciprocal), forward and gradient,
    equal as values (XLA's fp32 select writes +0 where bf16's product
    writes -0)."""
    kj, kt = _key(21)
    x = np.random.RandomState(0).randn(4, 33, 65).astype(np.float32) * 3
    g = np.random.RandomState(1).randn(4, 33, 65).astype(np.float32)
    if dtype == "bf16":
        x, g = x.astype(ml_dtypes.bfloat16), g.astype(ml_dtypes.bfloat16)
    y_j, vjp = jax.vjp(jax.jit(
        lambda a: jax_bert._maybe_dropout(a, rate, kj)), jnp.asarray(x))
    (dx_j,) = vjp(jnp.asarray(g))
    to_t = _bf16 if dtype == "bf16" else torch.from_numpy
    xt = to_t(x).requires_grad_(True)
    y = prng.dropout(kt, xt, rate)
    y.backward(to_t(g))
    for got, want in ((y.detach(), y_j), (xt.grad, dx_j)):
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want).astype(np.float32))


def test_dropout_constants():
    """A weak-typed 1 - rate takes x's dtype: bf16(0.9) is 0.8984375."""
    p, s = prng.dropout_constants(0.1, torch.bfloat16)
    assert p == float(np.float32(0.9))
    assert s == float(np.float32(1) / np.float32(0.8984375))
    assert prng.dropout(prng.PRNGKey(0), torch.ones(3), 0.0).tolist() == [
        1.0, 1.0, 1.0]


@pytest.mark.parametrize("bad", [object(), [1, 2, 3], [-1, 0],
                                 [0, 2 ** 32], np.zeros(2, np.float32)])
def test_malformed_keys_raise(bad):
    with pytest.raises((TypeError, ValueError)):
        prng.fold_in(bad, 1)


def test_chip_smoke_known_answers_are_jax():
    """``chip_smoke.THREEFRY_KNOWN``, the table the card's run (which has
    no JAX) holds the kernel to, is the installed jax's."""
    import importlib
    import os
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if repo not in sys.path:
        sys.path.insert(0, repo)
    table = importlib.import_module("chip_smoke").THREEFRY_KNOWN
    k = JR.PRNGKey
    jax_calls = {
        "split(PRNGKey(0), 2)": lambda: JR.split(k(0), 2),
        "fold_in(PRNGKey(0), 1)": lambda: JR.fold_in(k(0), 1),
        "bits(PRNGKey(0), (4,))": lambda: JR.bits(k(0), (4,)),
        "split(PRNGKey(42), 3)": lambda: JR.split(k(42), 3),
        "fold_in(PRNGKey(7), 2**32 - 1)": lambda: JR.fold_in(k(7),
                                                             2 ** 32 - 1),
        "bits(PRNGKey(1), (6,))": lambda: JR.bits(k(1), (6,)),
        "bits(fold_in(PRNGKey(3), 5), (3,))": lambda: JR.bits(
            JR.fold_in(k(3), 5), (3,)),
        "bits(PRNGKey(-1), (2,))": lambda: JR.bits(k(-1), (2,)),
        "uniform(PRNGKey(0), (4,)) as fp32 bits": lambda: np.asarray(
            JR.uniform(k(0), (4,))).view(np.uint32),
        "randint(PRNGKey(1000), (6,), 0, 1000)": lambda: JR.randint(
            k(1000), (6,), 0, 1000),
    }
    assert [c for c, _ in table] == list(jax_calls)
    for call, words in table:
        assert words == [int(w) for w in np.asarray(
            jax_calls[call]()).reshape(-1)], call

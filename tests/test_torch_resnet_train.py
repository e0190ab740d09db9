"""Port parity: ResNet training in ``apex_tpu_torch`` against the JAX
package's, on the CPU: the forward (``apply_resnet``), the gradients
through ``Amp.value_and_grad(has_aux=True)``, and two steps of
``examples/imagenet/main_amp.py::make_resnet_train_step`` in its three
configurations against the JAX example's step, built from
``amp.initialize``, ``FusedSGD``, ``apply_resnet`` and
``apply_if_finite`` as ``examples/imagenet/main_amp.py:113-124`` builds
it (the JAX flat ``FusedSGD`` runs its Pallas kernel in interpret mode,
the port its plain version). Both start from the same weights
(``init_resnet`` in JAX, carried across by ``params_from_jax``) and the
same numpy batch.

Size: ResNet-10, 10 classes, batch 4 at 64 x 64. At batch 2 and 32 x 32
the last stage's maps are 1 x 1, so its BatchNorm normalises over two
values and E[x^2] - E[x]^2 cancels: there the port's fp32 logits land
about a hundred times further from the same forward in float64 than at
batch 4 and 64 x 64 (2 x 2 maps, 16 values a channel), where they stay
within a few millionths of the largest logit
(``test_parity_size_is_well_conditioned`` prints both), so fp32 sum
orders cannot be held to each other at the former. The stem (64 -> 32)
and the stride-2 3 x 3 convolutions (16 -> 8, 8 -> 4, 4 -> 2) still pad
unevenly, so symmetric padding fails these tests.

Tolerances. O0 (fp32): logits within 2e-5 of the largest |logit|,
every gradient, BatchNorm statistic and momentum buffer within 5e-5 in
relative norm (conv sums in other orders, well inside), and each step's
master update (new master minus old) within 5e-5 in relative norm, leaf
by leaf. O2 (bf16 convolutions): both sides
round activations to bf16 at every layer, and through ten layers of
BatchNorm that noise is a large share of the gradient (about a fifth of
its norm for JAX and for the port alike, each against the fp32 gradient
of the same step; ``test_train_step_matches_jax`` prints both), so
port-against-JAX says little. The port is held instead to be no further
from the fp32 result than 1.5 times JAX's distance: the gradients, and
each step's master update. A port that padded, pooled or normalised
differently would sit far from fp32 while JAX stays close. The loss is
held within 5e-3 relative of JAX's plus JAX's own distance from the fp32
loss (on the second step the loss is near 0.0025, where 5e-3 of it is
below the bf16 noise)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import lax

from apex_tpu import amp as jamp
from apex_tpu.models import apply_resnet as japply
from apex_tpu.models import cross_entropy_loss as jce
from apex_tpu.models import init_resnet as jinit
from apex_tpu.optimizers import FusedSGD as JaxSGD
from apex_tpu_torch import amp as pamp
from apex_tpu_torch.examples.imagenet import main_amp
from apex_tpu_torch.examples.imagenet.main_amp import (
    CONFIGS, make_resnet_train_step,
)
from apex_tpu_torch.models import layers as L
from apex_tpu_torch.models import apply_resnet, init_resnet
from apex_tpu_torch.models._convert import params_from_jax
from apex_tpu_torch.optimizers import FusedSGD
from apex_tpu_torch.utils.tree import tree_flatten, tree_leaves

DEPTH, CLASSES, BATCH, SIZE = 10, 10, 4, 64
LR, MOM, WD = 0.1, 0.9, 1e-4
O0_REL, O2_FACTOR = 5e-5, 1.5


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(BATCH, SIZE, SIZE, 3).astype(np.float32)
    y = rng.randint(0, CLASSES, size=BATCH).astype(np.int64)
    return x, y


@pytest.fixture(scope="module")
def jax_init():
    return jinit(jax.random.PRNGKey(0), DEPTH, CLASSES)


def _port(tree):
    return params_from_jax(jax.tree.map(np.asarray, tree), "cpu")


def _leaves64(tree):
    """Leaves in JAX's order, float64 numpy (a JAX tree or a port tree)."""
    if isinstance(tree, (dict, list)) and tree_leaves(tree) and isinstance(
            tree_leaves(tree)[0], torch.Tensor):
        return [t.detach().double().numpy() for t in tree_flatten(tree)[0]]
    return [np.asarray(a, np.float64) for a in jax.tree_util.tree_leaves(
        tree)]


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _rel_leaves(got, want):
    return max(_rel(a, b) for a, b in zip(got, want))


def _rel_global(got, want):
    num = sum(float(np.sum((a - b) ** 2)) for a, b in zip(got, want))
    den = sum(float(np.sum(b ** 2)) for b in want)
    return (num / den) ** 0.5


def test_init_tree_matches_jax_layout(jax_init):
    """The port's ``init_resnet`` draws a tree with JAX's keys, leaf
    shapes and dtypes (HWIO kernels, fp32 BatchNorm leaves)."""
    jp, js = jax_init
    pp, ps = init_resnet(torch.Generator().manual_seed(0), DEPTH, CLASSES,
                         device="cpu")
    for port, ref in ((pp, jp), (ps, js)):
        pl, pdef = tree_flatten(port)
        jl, jdef = jax.tree_util.tree_flatten(ref)
        assert [tuple(t.shape) for t in pl] == [a.shape for a in jl]
        assert all(t.dtype == torch.float32 for t in pl)
        assert jax.tree_util.tree_structure(
            jax.tree.map(lambda t: 0, port)) == jdef


def test_params_from_jax_carries_the_resnet_pair(jax_init):
    """``params_from_jax`` carries both trees across leaf for leaf, bit
    for bit, keys and nesting kept."""
    for ref in jax_init:
        port = _port(ref)
        jl, jdef = jax.tree_util.tree_flatten(ref)
        assert jax.tree_util.tree_structure(
            jax.tree.map(lambda t: 0, port)) == jdef
        for a, t in zip(jl, tree_flatten(port)[0]):
            assert t.dtype == torch.float32 and t.device.type == "cpu"
            assert np.array_equal(t.numpy(), np.asarray(a))


@pytest.mark.parametrize("size,k,stride", [
    (64, 7, 2), (16, 3, 2), (15, 3, 2), (8, 1, 2), (9, 3, 1)])
def test_conv_same_padding_matches_xla(size, k, stride):
    """JAX's "SAME" pads (total // 2, total - total // 2): unevenly under
    stride 2 on an even size. ``conv`` matches XLA; a symmetric
    ``padding=k // 2`` would not wherever the pads differ."""
    rng = np.random.RandomState(size + k)
    x = rng.randn(2, size, size, 5).astype(np.float32)
    w = rng.randn(k, k, 5, 6).astype(np.float32)
    want = np.asarray(lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (stride, stride), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC")))
    got = L.conv({"kernel": torch.from_numpy(w)}, torch.from_numpy(x),
                 stride).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    lo, hi = L.same_pads(size, k, stride)
    sym = torch.nn.functional.conv2d(
        torch.from_numpy(x).permute(0, 3, 1, 2),
        torch.from_numpy(w).permute(3, 2, 0, 1), stride=stride,
        padding=k // 2).permute(0, 2, 3, 1).numpy()
    assert (lo == hi) == np.allclose(sym, want, rtol=1e-5, atol=1e-5)


def test_parity_size_is_well_conditioned():
    """The port's fp32 forward against the same forward in float64: at
    batch 2, 32 x 32 at least 30 times further apart (BatchNorm over two
    values a channel in the last stage) than at the tests' batch 4,
    64 x 64, which stays within 1e-5 of the largest logit."""
    from apex_tpu_torch.utils.tree import tree_map

    params, stats = init_resnet(torch.Generator().manual_seed(0), DEPTH,
                                CLASSES, device="cpu")
    errs = {}
    for batch, size in ((2, 32), (BATCH, SIZE)):
        x = torch.from_numpy(np.random.RandomState(batch).randn(
            batch, size, size, 3).astype(np.float32))
        y32, _ = apply_resnet(params, stats, x, DEPTH)
        y64, _ = apply_resnet(tree_map(lambda t: t.double(), params),
                              tree_map(lambda t: t.double(), stats),
                              x.double(), DEPTH)
        errs[(batch, size)] = float((y32.double() - y64).abs().max()
                                    / y64.abs().max())
    print(f"fp32 logits from float64, relative to the largest: {errs}")
    assert errs[(BATCH, SIZE)] <= 1e-5
    assert errs[(2, 32)] >= 30 * errs[(BATCH, SIZE)]


def test_forward_matches_jax(jax_init):
    jp, js = jax_init
    x, _ = _batch()
    jl, jns = japply(jp, js, jnp.asarray(x), DEPTH, train=True)
    tl, tns = apply_resnet(_port(jp), _port(js), torch.from_numpy(x), DEPTH,
                           train=True)
    jl = np.asarray(jl, np.float64)
    assert tl.shape == (BATCH, CLASSES)
    assert np.abs(tl.detach().double().numpy() - jl).max() <= \
        2e-5 * np.abs(jl).max()
    assert _rel_leaves(_leaves64(tns), _leaves64(jns)) <= O0_REL
    # eval mode reads the running statistics and returns them unchanged
    jle, _ = japply(jp, jns, jnp.asarray(x), DEPTH, train=False)
    tle, tse = apply_resnet(_port(jp), tns, torch.from_numpy(x), DEPTH,
                            train=False)
    assert all(a is b for a, b in zip(tree_leaves(tse), tree_leaves(tns)))
    np.testing.assert_allclose(tle.detach().numpy(), np.asarray(jle),
                               rtol=1e-4, atol=2e-5)


def _jax_step(opt_level, flat):
    """The JAX example's jitted step (``main_amp.py:113-124``), also
    returning the gradients."""
    h = jamp.initialize(opt_level=opt_level)
    opt = JaxSGD(lr=LR, momentum=MOM, weight_decay=WD, use_flat_kernel=flat)

    def loss_fn(p, stats, images, labels):
        logits, new_stats = japply(p, stats, images, DEPTH, train=True)
        return jce(logits, labels), new_stats

    @jax.jit
    def train_step(master, bn_stats, opt_state, scaler_state, images,
                   labels):
        p = h.cast_model(master)
        images = h.cast_input(images)
        (loss, new_stats), grads, found_inf, scaler_state = \
            h.value_and_grad(lambda q: loss_fn(q, bn_stats, images, labels),
                             has_aux=True)(p, scaler_state)
        master, opt_state = opt.step(grads, master, opt_state,
                                     found_inf=found_inf)
        new_stats = jamp.apply_if_finite(new_stats, bn_stats, found_inf)
        return master, new_stats, opt_state, scaler_state, loss, grads

    return h, opt, train_step


def _jax_run(jax_init, opt_level, flat, steps=2):
    """[(master, stats, opt_state, scaler, loss, grads)] after each step."""
    jp, js = jax_init
    h, opt, step = _jax_step(opt_level, flat)
    x, y = _batch()
    state = (jp, js, opt.init(jp), h.init_state())
    out = []
    for _ in range(steps):
        *state, loss, grads = step(*state, jnp.asarray(x), jnp.asarray(y))
        out.append((*state, loss, grads))
    return out


@pytest.fixture(scope="module")
def jax_runs(jax_init):
    return {name: _jax_run(jax_init, *CONFIGS[name]) for name in CONFIGS}


def _port_step(name):
    level, flat = CONFIGS[name]
    return make_resnet_train_step(DEPTH, level, optimizer=FusedSGD(
        lr=LR, momentum=MOM, weight_decay=WD, use_flat_kernel=flat))


def test_value_and_grad_has_aux_matches_jax(jax_init, jax_runs):
    """O0: the loss, the aux (new BatchNorm statistics, detached) and the
    gradients of ``Amp.value_and_grad(has_aux=True)``."""
    jp, js = jax_init
    x, y = _batch()
    h = pamp.initialize("O0", verbosity=0)

    def loss_fn(p, stats, images, labels):
        logits, new_stats = apply_resnet(p, stats, images, DEPTH)
        return main_amp.cross_entropy_loss(logits, labels), new_stats

    (loss, aux), grads, found_inf, st = h.value_and_grad(
        loss_fn, has_aux=True)(_port(jp), h.init_state("cpu"), _port(js),
                               torch.from_numpy(x), torch.from_numpy(y))
    assert not bool(found_inf) and int(st.unskipped) == 0
    assert not loss.requires_grad and not any(
        t.requires_grad for t in tree_leaves(aux))
    jm, jstats, _, _, jloss, jgrads = jax_runs["resnet_tree_o0"][0]
    assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    assert _rel_leaves(_leaves64(aux), _leaves64(jstats)) <= O0_REL
    assert _rel_leaves(_leaves64(grads), _leaves64(jgrads)) <= O0_REL


def _update(new, old):
    return [a - b for a, b in zip(_leaves64(new), _leaves64(old))]


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_train_step_matches_jax(jax_init, jax_runs, name):
    """Two steps of the same batch from the same weights."""
    jp, js = jax_init
    level, flat = CONFIGS[name]
    step = _port_step(name)
    x, y = (torch.from_numpy(a) for a in _batch())
    state = list(step.init_state(_port(jp), _port(js), "cpu"))
    ref = jax_runs["resnet_tree_o0"]     # the fp32 result, for O2
    prev_t, prev_j, prev_r = _port(jp), jp, jp
    for i, (jm, jstats, jopt, jsc, jloss, jgrads) in enumerate(
            jax_runs[name]):
        _, _, grads, found_inf, _ = step.grads(state[0], state[1], state[3],
                                               x, y)
        *state, loss = step(*state, x, y)
        assert not bool(found_inf)
        assert int(state[2].step) == int(jopt.step) == i + 1
        assert int(state[3].unskipped) == int(jsc.unskipped)
        assert float(state[3].loss_scale) == float(jsc.loss_scale)
        g_t, g_j = _leaves64(grads), _leaves64(jgrads)
        u_t, u_j = _update(state[0], prev_t), _update(jm, prev_j)
        if level == "O0":
            assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss))
            assert _rel_leaves(g_t, g_j) <= O0_REL
            assert _rel_leaves(u_t, u_j) <= O0_REL
            assert _rel_leaves(_leaves64(state[1]), _leaves64(jstats)) \
                <= O0_REL
            if flat:   # the flat buffers, laid out as JAX lays them out
                got = state[2].momentum_buf.double().numpy()
                want = np.asarray(jopt.momentum_buf, np.float64)
                assert got.shape == want.shape and _rel(got, want) <= O0_REL
            else:
                assert _rel_leaves(_leaves64(state[2].momentum_buf),
                                   _leaves64(jopt.momentum_buf)) <= O0_REL
        else:
            rm, rstats, _, _, rloss, rgrads = ref[i]
            lj, lr = float(jloss), float(rloss)
            assert abs(float(loss) - lj) <= 5e-3 * abs(lj) + abs(lj - lr)
            g_r = _leaves64(rgrads)
            d_port, d_jax = _rel_global(g_t, g_r), _rel_global(g_j, g_r)
            print(f"step {i + 1}: O2 gradients from fp32, port {d_port:.4f},"
                  f" JAX {d_jax:.4f}")
            assert d_port <= O2_FACTOR * d_jax
            u_r = _update(rm, prev_r)
            assert _rel_global(u_t, u_r) <= O2_FACTOR * _rel_global(u_j, u_r)
            assert all(t.dtype == torch.float32
                       for t in tree_leaves(state[0]))
            prev_r = rm
        prev_t, prev_j = state[0], jm


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_injected_inf_skips_the_step(jax_init, name):
    """An inf in the images makes the gradients non-finite: found_inf is
    True and params, momentum buffer, statistics and step count stay as
    they were (after one clean step, so the buffer is not zero); under
    O2's dynamic scale the scale halves."""
    jp, js = jax_init
    step = _port_step(name)
    x, y = (torch.from_numpy(a) for a in _batch())
    state = list(step(*step.init_state(_port(jp), _port(js), "cpu"), x, y))
    bad = x.clone()
    bad[0, 3, 5, 1] = float("inf")
    _, _, _, found_inf, _ = step.grads(state[0], state[1], state[3], bad, y)
    assert bool(found_inf)
    # snapshots: the flat path updates params and buffer in place
    snap = [t.clone() for t in tree_leaves(state[:3])]
    new = step(*state[:4], bad, y)
    for a, b in zip(tree_leaves(new[:3]), snap):
        assert torch.equal(a, b)
    assert int(new[2].step) == 1
    assert int(new[3].overflows) == int(state[3].overflows) + (
        1 if CONFIGS[name][0] == "O2" else 0)
    if CONFIGS[name][0] == "O2":
        assert float(new[3].loss_scale) == float(state[3].loss_scale) / 2


def test_cast_input_follows_the_opt_level():
    batch = {"images": torch.randn(2, 3), "labels": torch.arange(2)}
    o0 = pamp.initialize("O0", verbosity=0).cast_input(batch)
    assert o0["images"].dtype == torch.float32 and torch.equal(
        o0["images"], batch["images"])
    o2 = pamp.initialize("O2", verbosity=0).cast_input(batch)
    assert o2["images"].dtype == torch.bfloat16
    assert o2["labels"] is batch["labels"]
    assert pamp.initialize("O1", verbosity=0).cast_input(batch) is batch


def test_example_runs_on_the_cpu(capsys):
    main_amp.main(["--device", "cpu", "-a", "resnet10", "-b", "2",
                   "--image-size", "32", "--steps", "2", "--flat-kernel",
                   "--num-classes", "10"])
    out = capsys.readouterr().out
    assert "FINAL speed" in out and "step_time" in out


def test_unported_options_raise(jax_init, monkeypatch):
    """The example's checkpoint flags are ported (``--resume`` parses;
    ``tests/test_torch_checkpoint.py`` drives them) and an unknown flag
    still exits. SyncBatchNorm is ported, on ``torch.distributed`` (``tests/test_torch_parallel.py``):
    ``convert_syncbn_model`` resolves the ``data`` axis at the call, and
    with no process group brings up the card's, so on a host without
    CUDA it raises naming ``device='cpu'``, and never falls back to gloo
    by itself. The model zoo takes the resolved ``ProcessGroup`` only:
    a mesh axis name there raises."""
    from apex_tpu_torch.parallel import convert_syncbn_model

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert_syncbn_model(apply_resnet)(
            _port(jax_init[0]), _port(jax_init[1]),
            torch.zeros(1, 32, 32, 3), DEPTH)
    with pytest.raises(ValueError, match="ProcessGroup"):
        apply_resnet(_port(jax_init[0]), _port(jax_init[1]),
                     torch.zeros(1, 32, 32, 3), DEPTH, axis_name="data")
    with pytest.raises(ValueError, match="ProcessGroup"):
        L.batchnorm(None, None, torch.zeros(2, 3), train=True,
                    axis_name="data")
    assert not torch.distributed.is_initialized()
    args = main_amp.parse_args(["--resume", "ck.pt"])
    assert (args.resume, args.checkpoint, args.save_freq) == ("ck.pt", None,
                                                              0)
    with pytest.raises(SystemExit):
        main_amp.parse_args(["--no-such-option", "ck.pt"])


@pytest.mark.parametrize("i", [0, 3])
def test_synthetic_batch_is_the_jax_examples(i):
    """``synthetic_batch(i)`` draws what ``examples/imagenet/main_amp.py``
    draws for step i (``normal`` and ``randint`` on PRNGKey(1000 + i)):
    the labels exactly, the images within ``prng.normal_limit``."""
    from apex_tpu_torch.utils import prng

    k = jax.random.PRNGKey(1000 + i)
    want_x = np.asarray(jax.random.normal(k, (4, 16, 16, 3), jnp.float32))
    want_y = np.asarray(jax.random.randint(k, (4,), 0, 1000))
    x, y = main_amp.synthetic_batch(i, 4, 16, 1000, torch.device("cpu"))
    assert x.dtype == torch.float32 and y.dtype == torch.int64
    np.testing.assert_array_equal(y.numpy(), want_y)
    lim = prng.normal_limit(torch.from_numpy(want_x.copy())).numpy()
    assert np.all(np.abs(x.numpy() - want_x) <= lim)

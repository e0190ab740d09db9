"""Port parity: GPT training in ``apex_tpu_torch`` (``apply_gpt_unsharded``,
``gpt_loss_unsharded``, ``examples/gpt/train.py``'s step and
``examples/gpt/pretrain_gpt.py``) against the JAX package on the CPU.

The port runs its kernels' plain versions; the JAX side runs as its own
tests run it (Pallas in interpret mode, or its unfused paths at these
lengths). Weights are the JAX ``init_gpt`` tree carried across by
``params_from_jax`` (or drawn from the same key by ``init_gpt_from_key``).

Tolerances. fp32 compute: loss within 1e-6 relative and every gradient
within 1e-5 in relative norm (sums in other orders). bf16 compute over
fp32 params (the JAX benchmark's step): the two frameworks round
activations to bf16 at different places (XLA keeps fused intermediates
in fp32), so the loss is held within 2e-4 relative and each gradient
within 0.05 in relative norm, the limits of ``test_torch_bert_train.py``.
The tied word table's gradient is the sum of the lookup's and the logits
head's; JAX adds the two in bf16 (one cast of the table feeds both), the
port in fp32 (each use casts), inside the same limits. Two optimizer
steps hold m and v to the same relative norms (v twice the gradients'),
and master within 2 lr a step: an Adam step moves a leaf by at most
about lr, and a gradient near zero may change sign between the two.
Dropout is held to the jitted JAX function (XLA's rewrite of ``/ (1 -
rate)`` into a multiply by its reciprocal is what the port reproduces),
its masks bit for bit."""

import dataclasses
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.models import gpt as jax_gpt
from apex_tpu.optimizers import FusedAdam as JaxFusedAdam
from apex_tpu_torch.examples.gpt import pretrain_gpt
from apex_tpu_torch.examples.gpt.train import (
    make_gpt_train_step, synthetic_batch,
)
from apex_tpu_torch.models import gpt as port_gpt
from apex_tpu_torch.models._convert import params_from_jax
from apex_tpu_torch.optimizers import FusedAdam
from apex_tpu_torch.transformer.parallel_state import ParallelStateError
from apex_tpu_torch.utils import prng

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, S = 2, 16
LR = 1e-4
LIMITS = {"fp32": {"loss": 1e-6, "grads": 1e-5},
          "bf16": {"loss": 2e-4, "grads": 0.05}}
DTYPES = {"fp32": (None, None), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _cfgs(rope):
    return (dataclasses.replace(jax_gpt.gpt_tiny(), use_rope=rope),
            dataclasses.replace(port_gpt.gpt_tiny(), use_rope=rope))


def _port(tree):
    return params_from_jax(jax.tree.map(np.asarray, tree), "cpu")


def _by_path(tree, path=()):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_by_path(tree[k], path + (k,)))
        return out
    return {path: tree}


def _relnorm(want, got):
    want, got = want.double(), got.double()
    n = float(want.norm())
    return float((got - want).norm()) / (n if n > 0 else 1.0)


def _worst(jax_tree, port_tree):
    want, got = _by_path(_port(jax_tree)), _by_path(port_tree)
    assert want.keys() == got.keys()
    return max(_relnorm(want[k], got[k]) for k in want)


def _batch(vocab, seed=0):
    ids = np.random.RandomState(seed).randint(0, vocab, (B, S)).astype(
        np.int32)
    labels = np.roll(ids, -1, axis=1)
    return ids, labels


def _port_loss_and_grads(params, cfg, ids, labels, **kw):
    step = make_gpt_train_step(cfg, compute_dtype=kw.pop("compute_dtype"))
    return step.grads(params, torch.from_numpy(ids).long(),
                      torch.from_numpy(labels).long(), **kw)


def _jax_loss_and_grads(params, cfg, ids, labels, jit=False, **kw):
    fn = jax.value_and_grad(lambda p: jax_gpt.gpt_loss_unsharded(
        p, cfg, jnp.asarray(ids), jnp.asarray(labels), **kw))
    return (jax.jit(fn) if jit else fn)(params)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("rope", [False, True], ids=["learned", "rope"])
def test_loss_and_grads_match_jax(rope, dtype):
    """``gpt_loss_unsharded`` and its gradients (``jax.value_and_grad``)
    on gpt_tiny with learned positions and with RoPE."""
    jcfg, pcfg = _cfgs(rope)
    params = jax_gpt.init_gpt(jax.random.PRNGKey(1), jcfg)
    ids, labels = _batch(jcfg.vocab_size)
    jdt, tdt = DTYPES[dtype]
    wl, wg = _jax_loss_and_grads(params, jcfg, ids, labels,
                                 compute_dtype=jdt)
    gl, gg = _port_loss_and_grads(_port(params), pcfg, ids, labels,
                                  compute_dtype=tdt)
    lim = LIMITS[dtype]
    assert gl.dtype == torch.float32
    assert abs(float(gl) - float(wl)) <= lim["loss"] * abs(float(wl))
    assert _worst(wg, gg) <= lim["grads"]
    if rope:
        assert "position" not in _by_path(gg)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("rope", [False, True], ids=["learned", "rope"])
def test_dropout_matches_jitted_jax(rope, dtype):
    """With ``dropout_rng``: layer i draws on ``split(key, L)[i]``, the
    attention output's mask on ``fold_in(., 0)`` and fc2's on
    ``fold_in(., 1)``; the masks equal JAX's bit for bit and the loss and
    gradients equal the jitted JAX function's within the limits."""
    jcfg, pcfg = _cfgs(rope)
    key = 5
    shape = (B, S, jcfg.hidden_size)
    jkeys = jax.random.split(jax.random.PRNGKey(key), jcfg.num_layers)
    pkeys = prng.split(prng.PRNGKey(key), pcfg.num_layers)
    for i in range(jcfg.num_layers):
        for salt in (0, 1):
            want = np.asarray(jax.random.bernoulli(
                jax.random.fold_in(jkeys[i], salt), 0.9, shape))
            got = prng.bernoulli(prng.fold_in(pkeys[i], salt), 0.9, shape,
                                 device="cpu")
            np.testing.assert_array_equal(got.numpy(), want)
    params = jax_gpt.init_gpt(jax.random.PRNGKey(1), jcfg)
    ids, labels = _batch(jcfg.vocab_size)
    jdt, tdt = DTYPES[dtype]
    wl, wg = _jax_loss_and_grads(params, jcfg, ids, labels, jit=True,
                                 compute_dtype=jdt,
                                 dropout_rng=jax.random.PRNGKey(key))
    gl, gg = _port_loss_and_grads(_port(params), pcfg, ids, labels,
                                  compute_dtype=tdt,
                                  dropout_rng=prng.PRNGKey(key))
    off, _ = _port_loss_and_grads(_port(params), pcfg, ids, labels,
                                  compute_dtype=tdt)
    lim = LIMITS[dtype]
    assert abs(float(gl) - float(wl)) <= lim["loss"] * abs(float(wl))
    assert _worst(wg, gg) <= lim["grads"]
    assert float(off) != float(gl)


POLICIES = ["checkpoint_dots", "checkpoint_dots_with_no_batch_dims",
            "dots_saveable", "dots_with_no_batch_dims_saveable",
            "everything_saveable", "nothing_saveable", None]


@pytest.mark.parametrize("policy", POLICIES)
def test_remat_policies_give_the_same_gradients(policy):
    """``remat=True`` (full recompute, or each zero-argument policy of
    the reference) gives the gradients of no remat bit for bit on the
    CPU, with RoPE and dropout: the recompute draws the same masks
    (the keys are explicit)."""
    _, pcfg = _cfgs(True)
    params = port_gpt.init_gpt(pcfg, torch.Generator().manual_seed(0),
                               device="cpu")
    ids, labels = _batch(pcfg.vocab_size)
    kw = dict(compute_dtype=None, dropout_rng=prng.PRNGKey(2))
    wl, wg = _port_loss_and_grads(params, pcfg, ids, labels, **dict(kw))
    rcfg = dataclasses.replace(pcfg, remat=True, remat_policy=policy)
    gl, gg = _port_loss_and_grads(params, rcfg, ids, labels, **dict(kw))
    assert torch.equal(gl, wl)
    want, got = _by_path(wg), _by_path(gg)
    assert all(torch.equal(got[k], want[k]) for k in want)


def test_unknown_remat_policy_raises_like_jax():
    """A factory or unknown name raises the reference's ValueError."""
    jcfg, pcfg = _cfgs(False)
    name = "save_only_these_names"
    params = jax_gpt.init_gpt(jax.random.PRNGKey(1), jcfg)
    ids = jnp.zeros((1, 4), jnp.int32)
    with pytest.raises(ValueError) as want:
        jax_gpt.apply_gpt_unsharded(params, dataclasses.replace(
            jcfg, remat=True, remat_policy=name), ids)
    with pytest.raises(ValueError) as got:
        with torch.enable_grad():
            port_gpt.apply_gpt_unsharded(
                _port(params), dataclasses.replace(
                    pcfg, remat=True, remat_policy=name),
                torch.zeros((1, 4), dtype=torch.long))
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("field,value", [
    ("sequence_parallel", True), ("context_parallel", True),
    ("context_parallel_impl", "ulysses"),
    ("gradient_accumulation_fusion", True)])
def test_parallel_fields_raise_naming_a6(field, value):
    """The parallel fields build and run (the name is kept from the
    slices when the context-parallel ones raised, naming A6.2): the
    unsharded path ignores them, as the JAX package's does, and
    ``GPTModel`` on a world of one (tp 1, cp 1: the ring over one block,
    or Ulysses' identity all-to-alls around flash) gives the unsharded
    loss."""
    cfg = dataclasses.replace(port_gpt.gpt_tiny(), **{field: value})
    params = port_gpt.init_gpt(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
    ids = synthetic_batch(0, B, S, cfg.vocab_size, "cpu")
    want = port_gpt.gpt_loss_unsharded(params, cfg, ids, ids)
    want_plain = port_gpt.gpt_loss_unsharded(
        params, port_gpt.gpt_tiny(), ids, ids)
    assert torch.equal(want, want_plain)
    from apex_tpu_torch.transformer import parallel_state as ps

    P = ps.PartitionSpec
    ps.initialize_model_parallel(device="cpu")
    try:
        model = port_gpt.GPTModel(cfg)
        with torch.enable_grad():
            got = ps.shard_map(model.loss, in_specs=(
                model.partition_specs(), P(), P()), out_specs=P())(
                params, ids, ids)
    finally:
        ps.destroy_model_parallel()
        torch.distributed.destroy_process_group()
    assert torch.isfinite(got)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_configs_match_jax():
    for name in ("gpt_medium", "gpt_tiny", "draft_gpt_tiny",
                 "draft_gpt_medium"):
        want = dataclasses.asdict(getattr(jax_gpt, name)())
        assert dataclasses.asdict(getattr(port_gpt, name)()) == want, name
    assert port_gpt.gpt_medium().remat


def test_accumulate_tied_word_grads_matches_jax():
    rng = np.random.RandomState(0)
    tree = {"embed": {"word": {"embedding": rng.randn(8, 4)},
                      "position": {"embedding": rng.randn(3, 4)}},
            "stages": {"w": rng.randn(2, 2)},
            "head": {"word": {"embedding": rng.randn(8, 4)},
                     "final_ln": {"weight": rng.randn(4)}}}
    want = jax_gpt.accumulate_tied_word_grads(jax.tree.map(
        lambda a: jnp.asarray(a, jnp.float32), tree))
    got = port_gpt.accumulate_tied_word_grads(jax.tree.map(
        lambda a: torch.from_numpy(a.astype(np.float32)), tree))
    w, g = _by_path(jax.tree.map(np.asarray, want)), _by_path(got)
    assert w.keys() == g.keys()
    for k in w:
        np.testing.assert_array_equal(g[k].numpy(), w[k])


def test_init_gpt_from_key_matches_jax():
    """The JAX ``init_gpt`` draws from the same key, within
    ``prng.normal_limit`` times each leaf's scale, RoPE trees without a
    position table."""
    for rope in (False, True):
        jcfg, pcfg = _cfgs(rope)
        want = _by_path(_port(jax_gpt.init_gpt(jax.random.PRNGKey(7),
                                               jcfg)))
        got = _by_path(port_gpt.init_gpt_from_key(prng.PRNGKey(7), pcfg,
                                                  device="cpu"))
        assert got.keys() == want.keys()
        for k, w in want.items():
            scale = float(w.abs().max()) or 1.0
            z = w / scale
            lim = prng.normal_limit(z * 4) * scale   # |z| within 4 sigma
            assert (got[k] - w).abs().le(lim + 1e-30).all(), k


def test_two_steps_match_gpt_tp_bench_body1():
    """Two steps of ``make_gpt_train_step`` (bf16 compute over fp32
    params, tree FusedAdam(lr=1e-4, weight_decay=0.01)) against two of
    the JAX package's ``gpt_tp_bench(False, 1)`` ``body1`` (gpt_tiny, its
    zero batch) on the carried-over params: m within the bf16 gradient
    limit, v within twice it, master within 2 lr a step."""
    body1, make_init, _, batch = jax_gpt.gpt_tp_bench(False, 1)
    state = make_init()
    p0 = _port(state[0])
    for _ in range(2):
        state = body1(state)
    step = make_gpt_train_step(port_gpt.gpt_tiny())
    ids = torch.zeros((batch, 32), dtype=torch.long)
    params, opt_state = p0, step.opt.init(p0)
    losses = []
    for _ in range(2):
        params, opt_state, loss = step(params, opt_state, ids, ids)
        losses.append(float(loss))
    assert int(opt_state.step) == int(state[1].step) == 2
    assert _worst(state[1].m, opt_state.m) <= LIMITS["bf16"]["grads"]
    assert _worst(state[1].v, opt_state.v) <= 2 * LIMITS["bf16"]["grads"]
    want, got = _by_path(_port(state[0])), _by_path(params)
    assert max(float((got[k] - want[k]).abs().max()) for k in want) \
        <= 2 * 2 * LR + 1e-6
    assert losses[1] < losses[0]


def _reference_cli():
    """The reference ``examples/gpt/pretrain_gpt.py`` as a module (its
    ``extra_flags``; importing it runs nothing)."""
    path = os.path.join(REPO, "examples", "gpt", "pretrain_gpt.py")
    spec = importlib.util.spec_from_file_location("_ref_pretrain_gpt", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_cli_losses(argv):
    """The losses the reference CLI prints, from its own pieces, run
    without its buffer donation (which fails on the tied word table's two
    copies, ROADMAP's known red references) on one device: the port runs
    one, and the reference divides the global batch over every device of
    the mesh."""
    from jax import lax
    from jax.sharding import PartitionSpec as P

    from apex_tpu.transformer import parallel_state as ps
    from apex_tpu.transformer.pipeline_parallel.schedules import (
        forward_backward_no_pipelining,
    )
    from apex_tpu.transformer.testing import arguments

    ns = arguments.parse_args(extra_args_provider=_reference_cli()
                              .extra_flags, args=argv)
    ps.destroy_model_parallel()
    mesh = ps.initialize_model_parallel(
        ns.tensor_model_parallel_size, ns.pipeline_model_parallel_size,
        ns.virtual_pipeline_model_parallel_size,
        context_parallel_size_=ns.context_parallel_size,
        devices=jax.devices()[:1])
    try:
        cfg = jax_gpt.GPTConfig(
            vocab_size=ns.padded_vocab_size, hidden_size=ns.hidden_size,
            num_layers=ns.num_layers, num_heads=ns.num_attention_heads,
            ffn_hidden_size=4 * ns.hidden_size,
            max_position_embeddings=ns.max_position_embeddings)
        model = jax_gpt.GPTModel(cfg, tp_size=1)
        params = jax_gpt.gpt_to_pipeline_params(
            jax_gpt.init_gpt(jax.random.PRNGKey(ns.seed), cfg), cfg, 1)
        pipe_model = jax_gpt.gpt_pipeline_model(model)
        pspecs = jax_gpt.gpt_pipeline_partition_specs(cfg)
        opt = JaxFusedAdam(lr=ns.lr, weight_decay=0.01)
        opt_state = opt.init(params)
        ospecs = type(opt_state)(step=P(), m=pspecs, v=pspecs)
        M = ns.global_batch_size // ns.micro_batch_size

        def train_step(p, ostate, batch):
            loss, grads = forward_backward_no_pipelining(
                pipe_model, p, batch, num_microbatches=M)
            loss = lax.pmean(loss, ps.DATA_AXIS)
            grads = jax_gpt.accumulate_tied_word_grads(grads)
            grads = jax.tree.map(lambda g: lax.pmean(g, ps.DATA_AXIS), grads)
            p, ostate = opt.step(grads, p, ostate)
            return p, ostate, loss

        bspecs = {"input_ids": P(ps.DATA_AXIS), "labels": P(ps.DATA_AXIS)}
        step = jax.jit(ps.shard_map(train_step, mesh=mesh,
                                    in_specs=(pspecs, ospecs, bspecs),
                                    out_specs=(pspecs, ospecs, P())))
        losses = {}
        for i in range(ns.steps):
            ids = jax.random.randint(jax.random.PRNGKey(1000 + i),
                                     (ns.global_batch_size, ns.seq_length),
                                     0, cfg.vocab_size)
            params, opt_state, loss = step(params, opt_state,
                                           {"input_ids": ids, "labels": ids})
            if i % 2 == 0 or i == ns.steps - 1:
                losses[i] = float(loss)
        return losses
    finally:
        ps.destroy_model_parallel()


@pytest.mark.parametrize("micro", ["2", "8"])
def test_pretrain_gpt_matches_the_reference_cli(capsys, micro):
    """``pretrain_gpt.main`` at the reference's defaults (3 steps; micro
    batch 2, so 4 microbatches, and 8, one) prints the reference step's
    losses within 1e-5, about 6.241142 and 6.237219, then DONE."""
    argv = ["--steps", "3", "--micro-batch-size", micro]
    want = _jax_cli_losses(argv)
    assert pretrain_gpt.main(argv + ["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "mesh: dp=1 tp=1 pp=1" and lines[-1] == "DONE"
    got = {int(ln.split()[1]): float(ln.split()[3]) for ln in lines[1:-1]}
    assert got.keys() == want.keys() == {0, 2}
    for i in want:
        assert abs(got[i] - want[i]) <= 1e-5, (i, got[i], want[i])
    assert abs(got[0] - 6.241142) <= 1e-5 and abs(got[2] - 6.237219) <= 1e-5


@pytest.mark.parametrize("flag", [
    ["--tensor-model-parallel-size", "2"],
    ["--pipeline-model-parallel-size", "2"],
    ["--context-parallel-size", "2"], ["--sequence-parallel"],
    ["--use-distributed-optimizer"]])
def test_pretrain_gpt_parallel_flags_exit_naming_a6(flag, capsys):
    """The parallel flags on a world of one (the name is kept from the
    slices when each stopped the script, naming A6.2; the runs on two
    ranks are ``tests/test_torch_testing_rig.py``'s): a degree above 1
    is refused by the mesh, as the reference's is (the world does not
    split); sequence parallelism and ZeRO at one rank print the
    reference's step 0 loss."""
    argv = flag + ["--device", "cpu", "--steps", "1"]
    if len(flag) == 2:
        with pytest.raises(ParallelStateError, match="not divisible by "
                           "tp\\*pp\\*cp"):
            pretrain_gpt.main(argv)
        assert not torch.distributed.is_initialized()
        return
    assert pretrain_gpt.main(argv) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "mesh: dp=1 tp=1 pp=1" and lines[-1] == "DONE"
    assert abs(float(lines[1].split()[3]) - 6.241142) <= 1e-5


def test_synthetic_batch_is_jax_randint():
    want = np.asarray(jax.random.randint(jax.random.PRNGKey(1003), (4, 64),
                                         0, 50304))
    got = synthetic_batch(3, 4, 64, 50304, "cpu")
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)


def test_train_cli_runs_on_cpu(capsys):
    from apex_tpu_torch.examples.gpt import train

    assert train.main(["--config", "tiny", "--batch", "2", "--seq", "16",
                       "--steps", "2", "--use-rope", "--dropout-seed", "0",
                       "--flat-kernel", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "rope" in out and "flat FusedAdam" in out


def test_flat_and_tree_steps_agree():
    """The flat FusedAdam (one ``flat_adam`` kernel on the card) steps
    the GPT tree as the tree path does: masters within fp32 rounding."""
    cfg = port_gpt.gpt_tiny()
    ids = synthetic_batch(0, B, S, cfg.vocab_size, "cpu")
    outs = []
    for flat in (False, True):
        step = make_gpt_train_step(cfg, FusedAdam(
            lr=LR, weight_decay=0.01, use_flat_kernel=flat))
        p = port_gpt.init_gpt(cfg, torch.Generator().manual_seed(0),
                              device="cpu")
        p, o, _ = step(p, step.opt.init(p), ids, ids)
        outs.append(_by_path(p))
    for k in outs[0]:
        torch.testing.assert_close(outs[1][k], outs[0][k], rtol=0,
                                   atol=1e-6)


def _chip_smoke():
    import sys

    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    return importlib.import_module("chip_smoke")


@pytest.mark.parametrize("remat,dropout,flat", [
    (True, False, False), (True, True, True), (False, True, False),
    (False, False, True)])
def test_per_step_launches_match_the_card_count(monkeypatch, remat,
                                                dropout, flat):
    """``chip_smoke.gpt_per_step_launches``, which the card run holds
    every kernel's launches to, counted on the CPU: each call of a
    kernel's plain version is where the card launches the kernel (the
    flash backward's one plain call stands for its dq and dk/dv
    launches). Under remat the recompute stops after each layer's fc2
    product, so fc2's dropout is not drawn again."""
    ln = importlib.import_module(
        "apex_tpu_torch.normalization.fused_layer_norm")
    fa = importlib.import_module(
        "apex_tpu_torch.transformer.functional.flash_attention")
    xent = importlib.import_module("apex_tpu_torch.contrib.xentropy")
    mta = importlib.import_module("apex_tpu_torch.multi_tensor_apply.kernels")
    counts = {}

    def count(mod, fn, *names):
        orig = getattr(mod, fn)

        def counted(*a, **k):
            for n in names:
                counts[n] = counts.get(n, 0) + 1
            return orig(*a, **k)

        monkeypatch.setattr(mod, fn, counted)

    count(ln, "layer_norm_fwd_plain", "layer_norm_fwd")
    count(ln, "layer_norm_bwd_plain", "layer_norm_bwd")
    count(fa, "attention_fwd_plain", "flash_attention_fwd")
    count(fa, "attention_bwd_plain", "flash_attention_bwd_dq",
          "flash_attention_bwd_dkv")
    count(xent, "xentropy_fwd_plain", "xentropy_fwd")
    count(xent, "xentropy_bwd_plain", "xentropy_bwd")
    count(mta, "flat_adam_plain", "flat_adam")
    count(prng, "dropout_plain", "threefry_dropout")
    cfg = dataclasses.replace(port_gpt.gpt_tiny(), use_rope=True,
                              remat=remat)
    step = make_gpt_train_step(
        cfg, FusedAdam(lr=LR, weight_decay=0.01, use_flat_kernel=flat),
        dropout_rng=prng.PRNGKey(0) if dropout else None)
    p = port_gpt.init_gpt(cfg, torch.Generator().manual_seed(0),
                          device="cpu")
    ids = synthetic_batch(0, B, S, cfg.vocab_size, "cpu")
    o = step.opt.init(p)
    p, o, _ = step(p, o, ids, ids)
    counts.clear()
    step(p, o, ids, ids)
    want = _chip_smoke().gpt_per_step_launches(cfg.num_layers, remat,
                                               dropout, flat)
    assert counts == {n: c for n, c in want.items() if c}

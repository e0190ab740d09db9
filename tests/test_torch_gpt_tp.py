"""Port parity of GPT's tensor- and sequence-parallel path (``GPTModel``,
``gpt_tp_bench``) against the JAX package on the CPU.

The reference's ``test_tp8_loss_and_grads_match_unsharded`` cases,
(use_rope, sequence_parallel) in {(F, F), (T, F), (F, T)}, at tp 2 and
4: the port's ``GPTModel.loss`` and its gradients inside the port's
``parallel_state.shard_map(in_specs=(specs, P(), P()), out_specs=(P(),
specs))`` (the sequence-parallel gradients all-reduced first), in tp
gloo ranks (``tests/_torch_ranks.py``), against the JAX package's
unsharded loss and gradients, at the reference's tolerances (loss 1e-5
relative, gradients 2e-4 relative and 2e-5 absolute; fp32). Every rank's
loss and gathered gradients are the same bits. Also: the tp 1 path (a
dp 2 mesh) against the unsharded loss to 1e-5; the hidden dropout against
the JAX package's tensor-parallel run at the same tp (its keys: the same
on every rank without SP, the model rank folded in with it), at the same
tolerances; and one step of ``gpt_tp_bench``'s body at tp 1, 2 and 4
against the JAX package's (bf16 compute over fp32 params: m within the
bf16 gradient limit of ``tests/test_torch_gpt_train.py``, 0.05 in
relative norm, v within twice it, the params within 2 lr; the weights
are ``init_gpt_from_key``'s, the JAX draws within
``prng.normal_limit``).

Weights are the JAX ``init_gpt`` tree carried across by
``params_from_jax``; ids and labels the reference's
``randint(split(PRNGKey(42)))``. The JAX runs are memoized for the
module; this module imports no JAX at its top."""

import dataclasses
import functools
import importlib
import os
import sys

import numpy as np
import pytest
import torch

from _torch_ranks import spawn
from apex_tpu_torch.examples.gpt.train import make_gpt_tp_train_step
from apex_tpu_torch.models import gpt as port_gpt
from apex_tpu_torch.transformer import parallel_state as ps
from apex_tpu_torch.utils import prng

P = ps.PartitionSpec
B, S = 2, 16
CASES = [(False, False), (True, False), (False, True)]
DROPOUT_SEED = 7
LR = 1e-4
BF16_GRADS = 0.05


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(rope=False, sp=False):
    return dataclasses.replace(port_gpt.gpt_tiny(), use_rope=rope,
                               sequence_parallel=sp)


def _jax():
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as JP

    from apex_tpu.models import gpt as jax_gpt
    from apex_tpu.transformer import parallel_state as jps
    return jax, jnp, JP, jax_gpt, jps


def _jcfg(rope=False, sp=False):
    _, _, _, jax_gpt, _ = _jax()
    return dataclasses.replace(jax_gpt.gpt_tiny(), use_rope=rope,
                               sequence_parallel=sp)


@functools.lru_cache(maxsize=None)
def _jax_inputs(rope):
    jax, _, _, jax_gpt, _ = _jax()
    cfg = _jcfg(rope)
    params = jax_gpt.init_gpt(jax.random.PRNGKey(0), cfg)
    k1, k2 = jax.random.split(jax.random.PRNGKey(42))
    ids = jax.random.randint(k1, (B, S), 0, cfg.vocab_size)
    labels = jax.random.randint(k2, (B, S), 0, cfg.vocab_size)
    return params, ids, labels


@functools.lru_cache(maxsize=None)
def _jax_unsharded(rope):
    jax, _, _, jax_gpt, _ = _jax()
    params, ids, labels = _jax_inputs(rope)
    cfg = _jcfg(rope)
    loss, grads = jax.value_and_grad(
        lambda p: jax_gpt.gpt_loss_unsharded(p, cfg, ids, labels))(params)
    return float(loss), jax.tree.map(np.asarray, grads)


@functools.lru_cache(maxsize=None)
def _jax_tp_dropout(tp, sp):
    """The JAX package's GPTModel loss and gradients with dropout at tp
    ``tp`` (the reference test's shard_map)."""
    jax, _, JP, jax_gpt, jps = _jax()
    params, ids, labels = _jax_inputs(False)
    cfg = _jcfg(False, sp)
    mesh = jps.initialize_model_parallel(tensor_model_parallel_size_=tp,
                                         devices=jax.devices()[:tp])
    try:
        model = jax_gpt.GPTModel(cfg, tp_size=tp)
        specs = model.partition_specs()

        def loss_and_grads(p, ids, labels, key):
            loss, grads = jax.value_and_grad(model.loss)(
                p, ids, labels, dropout_rng=key)
            return loss, model.allreduce_sequence_parallel_grads(grads)

        loss, grads = jax.jit(jps.shard_map(
            loss_and_grads, mesh=mesh, in_specs=(specs, JP(), JP(), JP()),
            out_specs=(JP(), specs)))(params, ids, labels,
                                      jax.random.PRNGKey(DROPOUT_SEED))
    finally:
        jps.destroy_model_parallel()
    return float(loss), jax.tree.map(np.asarray, grads)


@functools.lru_cache(maxsize=None)
def _jax_bench(tp):
    """One step of the JAX package's ``gpt_tp_bench(False, tp)`` body:
    (params, m, v, step)."""
    jax, _, _, jax_gpt, jps = _jax()
    try:
        body, make_init, _, batch = jax_gpt.gpt_tp_bench(False, tp)
        p, o = body(make_init())
        return (jax.tree.map(np.asarray, p), jax.tree.map(np.asarray, o.m),
                jax.tree.map(np.asarray, o.v), int(o.step), batch)
    finally:
        jps.destroy_model_parallel()


def _port(tree):
    from apex_tpu_torch.models._convert import params_from_jax

    jax = _jax()[0]
    return params_from_jax(jax.tree.map(np.asarray, tree), "cpu")


# ---------------------------------------------------------------------------
# the port side, in each rank
# ---------------------------------------------------------------------------

# the kernels' plain versions, each call where the card launches the
# kernel (the flash backward's one call stands for its dq and dk/dv)
PLAIN_CALLS = (
    ("apex_tpu_torch.normalization.fused_layer_norm", "layer_norm_fwd_plain",
     ("layer_norm_fwd",)),
    ("apex_tpu_torch.normalization.fused_layer_norm", "layer_norm_bwd_plain",
     ("layer_norm_bwd",)),
    ("apex_tpu_torch.transformer.functional.flash_attention",
     "attention_fwd_plain", ("flash_attention_fwd",)),
    ("apex_tpu_torch.transformer.functional.flash_attention",
     "attention_bwd_plain", ("flash_attention_bwd_dq",
                             "flash_attention_bwd_dkv")),
    ("apex_tpu_torch.contrib.xentropy", "xentropy_fwd_plain",
     ("xentropy_fwd",)),
    ("apex_tpu_torch.contrib.xentropy", "xentropy_bwd_plain",
     ("xentropy_bwd",)),
    ("apex_tpu_torch.multi_tensor_apply.kernels", "flat_adam_plain",
     ("flat_adam",)),
    ("apex_tpu_torch.utils.prng", "dropout_plain", ("threefry_dropout",)),
)
LAUNCH_CASES = [(True, False, False), (True, True, True),
                (False, True, False)]   # (remat, dropout, sp)


def _counted_step(params, ids, remat, dropout, sp, world):
    """Each kernel's plain calls in the second of two tensor-parallel
    steps (gradients and the tree FusedAdam)."""
    counts = {}
    saved = []
    for mod_name, fn, names in PLAIN_CALLS:
        mod = importlib.import_module(mod_name)
        orig = getattr(mod, fn)

        def counted(*a, _orig=orig, _names=names, **k):
            for n in _names:
                counts[n] = counts.get(n, 0) + 1
            return _orig(*a, **k)

        saved.append((mod, fn, orig))
        setattr(mod, fn, counted)
    try:
        cfg = dataclasses.replace(_cfg(True, sp), remat=remat)
        step = make_gpt_tp_train_step(
            port_gpt.GPTModel(cfg, tp_size=world),
            dropout_rng=prng.PRNGKey(DROPOUT_SEED) if dropout else None)
        p, o = params, step.opt.init(params)
        p, o, _ = step(p, o, ids, ids)
        counts.clear()
        step(p, o, ids, ids)
    finally:
        for mod, fn, orig in saved:
            setattr(mod, fn, orig)
    return counts

def job(rank, world, tmp):
    d = torch.load(os.path.join(tmp, "inputs.pt"))
    out = {}
    ps.initialize_model_parallel(world, device="cpu")
    for rope, sp in CASES:
        step = make_gpt_tp_train_step(
            port_gpt.GPTModel(_cfg(rope, sp), tp_size=world),
            compute_dtype=None)
        out[(rope, sp)] = step.grads(d["params"][rope], d["ids"],
                                     d["labels"])
    if world == 2:
        for case in LAUNCH_CASES:
            out[("launches",) + case] = _counted_step(
                d["params"][True], d["ids"], *case, world)
        for sp in (False, True):
            step = make_gpt_tp_train_step(
                port_gpt.GPTModel(_cfg(False, sp), tp_size=world),
                compute_dtype=None)
            out[("dropout", sp)] = step.grads(
                d["params"][False], d["ids"], d["labels"],
                dropout_rng=prng.PRNGKey(DROPOUT_SEED))
        ps.destroy_model_parallel()
        # tp 1: the model axis of one rank, the two ranks data-parallel
        ps.initialize_model_parallel(1, device="cpu")
        model = port_gpt.GPTModel(_cfg(), tp_size=1)
        out["tp1"] = ps.shard_map(
            model.loss, in_specs=(model.partition_specs(), P(), P()),
            out_specs=P())(d["params"][False], d["ids"], d["labels"])
    body, make_init, fetch, batch = port_gpt.gpt_tp_bench(False, world,
                                                          device="cpu")
    p, o = body(make_init())
    out["bench"] = (p, o.m, o.v, int(o.step), batch, float(fetch((p, o))))
    return out


def _inputs_file(tmp):
    _, ids, labels = _jax_inputs(False)
    torch.save({"params": {rope: _port(_jax_inputs(rope)[0])
                           for rope in (False, True)},
                "ids": torch.from_numpy(np.array(ids)).long(),
                "labels": torch.from_numpy(np.array(labels)).long()},
               os.path.join(tmp, "inputs.pt"))


@pytest.fixture(scope="module")
def w2(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("gpt_tp2")
    _inputs_file(tmp)
    return spawn(job, 2, tmp)


@pytest.fixture(scope="module")
def w4(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("gpt_tp4")
    _inputs_file(tmp)
    return spawn(job, 4, tmp)


# ---------------------------------------------------------------------------
# comparisons
# ---------------------------------------------------------------------------

def _by_path(tree, path=()):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_by_path(tree[k], path + (k,)))
        return out
    return {path: tree}


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def _held(got_loss, got_grads, want_loss, want_grads):
    np.testing.assert_allclose(float(got_loss), want_loss, rtol=1e-5)
    got, want = _by_path(got_grads), _by_path(want_grads)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(_np(got[k]), want[k], rtol=2e-4,
                                   atol=2e-5, err_msg=str(k))


def _replicated(res, key):
    """Every rank's loss and gathered gradients are rank 0's bits."""
    loss0, grads0 = res[0][key]
    g0 = _by_path(grads0)
    for r in res[1:]:
        loss, grads = r[key]
        assert torch.equal(loss, loss0)
        g = _by_path(grads)
        assert all(torch.equal(g[k], g0[k]) for k in g0)


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("rope,sp", CASES)
def test_tp_loss_and_grads_match_unsharded(tp, rope, sp, request):
    res = request.getfixturevalue(f"w{tp}")
    want_loss, want_grads = _jax_unsharded(rope)
    for r in res:
        _held(*r[(rope, sp)], want_loss, want_grads)
    _replicated(res, (rope, sp))


def test_tp1_matches_unsharded(w2):
    """The tensor-parallel code at tp 1 (every region the identity)
    gives the unsharded loss; both data ranks the same bits."""
    want, _ = _jax_unsharded(False)
    for r in w2:
        np.testing.assert_allclose(float(r["tp1"]), want, rtol=1e-5)
    assert torch.equal(w2[0]["tp1"], w2[1]["tp1"])


@pytest.mark.parametrize("sp", [False, True])
def test_dropout_matches_jax_at_the_same_tp(w2, sp):
    want_loss, want_grads = _jax_tp_dropout(2, sp)
    for r in w2:
        _held(*r[("dropout", sp)], want_loss, want_grads)
    _replicated(w2, ("dropout", sp))
    # the dropout ran: the loss moved off the dropout-free one
    assert abs(want_loss - _jax_unsharded(False)[0]) > 1e-4


def _relnorm(want, got):
    want, got = torch.from_numpy(np.array(want)).double(), got.double()
    n = float(want.norm())
    return float((got - want).norm()) / (n if n > 0 else 1.0)


def _bench_held(got, want):
    p, m, v, step, batch = want
    gp, gm, gv, gstep, gbatch = got[:5]
    assert gstep == step == 1 and gbatch == batch
    for name, w, g, lim in (("m", m, gm, BF16_GRADS),
                            ("v", v, gv, 2 * BF16_GRADS)):
        w, g = _by_path(w), _by_path(g)
        assert w.keys() == g.keys()
        worst = max(_relnorm(w[k], g[k]) for k in w)
        assert worst <= lim, (name, worst)
    w, g = _by_path(p), _by_path(gp)
    assert max(float(np.abs(_np(g[k]) - w[k]).max()) for k in w) \
        <= 2 * LR + 1e-6


@pytest.mark.parametrize("tp", [2, 4])
def test_gpt_tp_bench_body_matches_jax(tp, request):
    """One step of ``gpt_tp_bench(False, tp)``'s body on every rank
    against the JAX package's; the ranks' new params the same bits."""
    res = request.getfixturevalue(f"w{tp}")
    want = _jax_bench(tp)
    for r in res:
        _bench_held(r["bench"], want)
    p0 = _by_path(res[0]["bench"][0])
    for r in res[1:]:
        p = _by_path(r["bench"][0])
        assert all(torch.equal(p[k], p0[k]) for k in p0)


def _chip_smoke():
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if repo not in sys.path:
        sys.path.insert(0, repo)
    return importlib.import_module("chip_smoke")


@pytest.mark.parametrize("remat,dropout,sp", LAUNCH_CASES)
def test_per_step_launches_match_the_card_count(w2, remat, dropout, sp):
    """``chip_smoke.gpt_tp_per_step_launches``, which the card run holds
    each rank's launches to, counted on the CPU in each of two ranks: the
    unsharded step's LayerNorm, flash and dropout calls, and no cross
    entropy (the vocab-parallel loss is plain ops)."""
    want = _chip_smoke().gpt_tp_per_step_launches(
        port_gpt.gpt_tiny().num_layers, remat, dropout, False)
    for r in w2:
        assert r[("launches", remat, dropout, sp)] == {
            n: c for n, c in want.items() if c}


def test_gpt_tp_bench_tp1_matches_jax():
    """At tp 1 the body is the unsharded step (no mesh)."""
    body, make_init, fetch, batch = port_gpt.gpt_tp_bench(False, 1,
                                                          device="cpu")
    p, o = body(make_init())
    _bench_held((p, o.m, o.v, int(o.step), batch), _jax_bench(1))
    assert np.isfinite(float(fetch((p, o))))

"""Port parity of GPT's pipeline adapter and context-parallel branch
against the JAX package on the CPU.

The reference's ``test_gpt.py`` cases at W <= 4 gloo ranks
(``tests/_torch_ranks.py``), the weights the JAX ``init_gpt(PRNGKey(0))``
tree carried across by ``params_from_jax``, ids and labels the
reference's ``randint(split(PRNGKey(42)))``:

- ``test_pipeline_gpt_matches_unsharded``: ``gpt_to_pipeline_params``,
  ``gpt_pipeline_model`` and the 1F1B or interleaved schedule inside
  ``parallel_state.shard_map`` over ``gpt_pipeline_partition_specs`` at
  pp 2; pp 4; pp 2 with vpp 2; pp 2 with tp 2 and SP; pp 2 with tp 2,
  SP and RoPE (2 microbatches), against the JAX package's unsharded loss
  (1e-5 relative) and gradients (2e-4 relative, 2e-5 absolute; the tied
  word table as the sum of its two copies);
- ``test_context_parallel_matches_unsharded``: ``GPTModel.loss`` with
  ``context_parallel`` on the ids and labels split on s over the
  ``context`` axis, the gradients meaned over it, at cp 2 ring; cp 4 ring
  with RoPE; tp 2 with cp 2 ring; cp 4 Ulysses with RoPE; tp 2 with cp 2
  Ulysses, against the unsharded loss (1e-5) and gradients (3e-4 /
  3e-5);
- the round-robin layout and the pipeline specs, leaf by leaf against
  the JAX package's.

This module imports no JAX at its top."""

import dataclasses
import functools
import os

import numpy as np
import pytest
import torch

from _torch_ranks import spawn
from apex_tpu_torch.examples.gpt.train import value_and_grad
from apex_tpu_torch.models import gpt as port_gpt
from apex_tpu_torch.transformer import parallel_state as ps
from apex_tpu_torch.transformer.pipeline_parallel import schedules
from apex_tpu_torch.transformer.tensor_parallel.mappings import collective

P = ps.PartitionSpec
B, S, MICROBATCHES = 2, 16, 2
# (pp, vpp, tp, sp, rope)
PIPE_CASES = [(2, None, 1, False, False), (4, None, 1, False, False),
              (2, 2, 1, False, False), (2, None, 2, True, False),
              (2, None, 2, True, True)]
# (rope, tp, cp, impl)
CP_CASES = [(False, 1, 2, "ring"), (True, 1, 4, "ring"),
            (False, 2, 2, "ring"), (True, 1, 4, "ulysses"),
            (False, 2, 2, "ulysses")]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _world(case):
    return case[0] * case[2] if len(case) == 5 else case[1] * case[2]


def _cfg(rope=False, **kw):
    return dataclasses.replace(port_gpt.gpt_tiny(), use_rope=rope, **kw)


# ---------------------------------------------------------------------------
# the JAX side (memoized; imported lazily)
# ---------------------------------------------------------------------------

def _jax():
    import jax

    from apex_tpu.models import gpt as jax_gpt
    return jax, jax_gpt


def _jcfg(rope=False, **kw):
    return dataclasses.replace(_jax()[1].gpt_tiny(), use_rope=rope, **kw)


@functools.lru_cache(maxsize=None)
def _jax_inputs(rope):
    jax, jax_gpt = _jax()
    cfg = _jcfg(rope)
    params = jax_gpt.init_gpt(jax.random.PRNGKey(0), cfg)
    k1, k2 = jax.random.split(jax.random.PRNGKey(42))
    ids = jax.random.randint(k1, (B, S), 0, cfg.vocab_size)
    labels = jax.random.randint(k2, (B, S), 0, cfg.vocab_size)
    return params, ids, labels


@functools.lru_cache(maxsize=None)
def _jax_unsharded(rope):
    jax, jax_gpt = _jax()
    params, ids, labels = _jax_inputs(rope)
    loss, grads = jax.value_and_grad(lambda p: jax_gpt.gpt_loss_unsharded(
        p, _jcfg(rope), ids, labels))(params)
    return float(loss), jax.tree.map(np.asarray, grads)


def _port(tree):
    from apex_tpu_torch.models._convert import params_from_jax

    return params_from_jax(_jax()[0].tree.map(np.asarray, tree), "cpu")


# ---------------------------------------------------------------------------
# the port side, in each rank
# ---------------------------------------------------------------------------

def _pipeline(case, params, ids, labels):
    pp, vpp, tp, sp, rope = case
    ps.destroy_model_parallel()
    ps.initialize_model_parallel(tp, pp, vpp, device="cpu")
    cfg = _cfg(rope, sequence_parallel=sp)
    model = port_gpt.GPTModel(cfg, tp_size=tp)
    pipe = port_gpt.gpt_to_pipeline_params(params, cfg, pp, vpp)
    specs = port_gpt.gpt_pipeline_partition_specs(cfg, vpp)
    fwd_bwd = (schedules.forward_backward_pipelining_with_interleaving
               if vpp else
               schedules.forward_backward_pipelining_without_interleaving)
    pipe_model = port_gpt.gpt_pipeline_model(model)

    def run(p, b):
        loss, grads = fwd_bwd(pipe_model, p, b,
                              num_microbatches=MICROBATCHES)
        return loss, model.allreduce_sequence_parallel_grads(grads)

    return ps.shard_map(run, in_specs=(specs, P()), out_specs=(P(), specs))(
        pipe, {"input_ids": ids, "labels": labels})


def _context(case, params, ids, labels):
    rope, tp, cp, impl = case
    ps.destroy_model_parallel()
    ps.initialize_model_parallel(tp, context_parallel_size_=cp,
                                 device="cpu")
    cfg = _cfg(rope, context_parallel=True, context_parallel_impl=impl)
    model = port_gpt.GPTModel(cfg, tp_size=tp)
    vg = value_and_grad(model.loss)
    mesh = ps.get_mesh()

    def run(p, ids, labels):
        loss, grads = vg(p, ids, labels)
        # the context axis splits the TOKENS as DDP splits the batch:
        # each rank's backward gives d(its own mean)/dp, so the closure
        # is the mean over the axis
        grads = {k: _mean_context(v, mesh) for k, v in grads.items()}
        return loss, grads

    seq = P(None, ps.CONTEXT_AXIS)
    return ps.shard_map(run, in_specs=(model.partition_specs(), seq, seq),
                        out_specs=(P(), model.partition_specs()))(
        params, ids, labels)


def _mean_context(tree, mesh):
    if isinstance(tree, dict):
        return {k: _mean_context(v, mesh) for k, v in tree.items()}
    cp = mesh.shape[ps.CONTEXT_AXIS]
    return collective("all_reduce", tree, mesh.groups[ps.CONTEXT_AXIS],
                      mesh.members(ps.CONTEXT_AXIS)) / cp


def job(rank, world, tmp):
    d = torch.load(os.path.join(tmp, "inputs.pt"))
    out = {}
    for case in PIPE_CASES:
        if _world(case) == world:
            out[("pipe",) + case] = _pipeline(
                case, d["params"][case[4]], d["ids"], d["labels"])
    for case in CP_CASES:
        if _world(case) == world:
            out[("cp",) + case] = _context(
                case, d["params"][case[0]], d["ids"], d["labels"])
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
    tmp = tmp_path_factory.mktemp("gpt_ppcp2")
    _inputs_file(tmp)
    return spawn(job, 2, tmp)


@pytest.fixture(scope="module")
def w4(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("gpt_ppcp4")
    _inputs_file(tmp)
    return spawn(job, 4, tmp, timeout=600)


# ---------------------------------------------------------------------------
# comparisons
# ---------------------------------------------------------------------------

def _np(t):
    return t.detach().double().numpy()


def _close(got, want, rtol, atol, what):
    assert tuple(got.shape) == want.shape, what
    np.testing.assert_allclose(_np(got), want, rtol=rtol, atol=atol,
                               err_msg=str(what))


def _to_pipe(tree, pp, vpp, L):
    """A JAX-layout tree (numpy) in ``gpt_to_pipeline_params``' layout."""
    chunks = pp * (vpp or 1)
    shape = (pp,) if vpp is None else (vpp, pp)
    return {name: {k: v.reshape(shape + (L // chunks,) + v.shape[1:])
                   for k, v in p.items()}
            for name, p in tree["layers"].items()}


@pytest.mark.parametrize("pp,vpp,tp,sp,rope", PIPE_CASES)
def test_pipeline_gpt_matches_unsharded(pp, vpp, tp, sp, rope, request):
    res = request.getfixturevalue(f"w{pp * tp}")
    want_loss, want = _jax_unsharded(rope)
    want_stages = _to_pipe(want, pp, vpp, port_gpt.gpt_tiny().num_layers)
    for r in res:
        loss, grads = r[("pipe", pp, vpp, tp, sp, rope)]
        np.testing.assert_allclose(float(loss), want_loss, rtol=1e-5)
        # the tied table's gradient is the sum of its two copies'
        word = grads["embed"]["word"]["embedding"] \
            + grads["head"]["word"]["embedding"]
        _close(word, want["embedding"]["word"]["embedding"], 2e-4, 2e-5,
               "word")
        for name, p in want_stages.items():
            for k, w in p.items():
                _close(grads["stages"][name][k], w, 2e-4, 2e-5, (name, k))
        for k in ("weight", "bias"):
            _close(grads["head"]["final_ln"][k], want["final_ln"][k], 2e-4,
                   2e-5, ("final_ln", k))
        if not rope:
            _close(grads["embed"]["position"]["embedding"],
                   want["embedding"]["position"]["embedding"], 2e-4, 2e-5,
                   "position")


def _flat(tree, path=()):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], path + (k,)))
        return out
    return {path: tree}


@pytest.mark.parametrize("rope,tp,cp,impl", CP_CASES)
def test_context_parallel_matches_unsharded(rope, tp, cp, impl, request):
    res = request.getfixturevalue(f"w{tp * cp}")
    want_loss, want = _jax_unsharded(rope)
    want = _flat(want)
    for r in res:
        loss, grads = r[("cp", rope, tp, cp, impl)]
        np.testing.assert_allclose(float(loss), want_loss, rtol=1e-5)
        got = _flat(grads)
        assert got.keys() == want.keys()
        for k in want:
            _close(got[k], want[k], 3e-4, 3e-5, k)


def test_pipeline_param_roundrobin_layout():
    """Chunk c lives at [lane c // pp, rank c % pp], the reference's
    round-robin; the port's layout equals the JAX package's leaf by
    leaf (the head's word table a copy of the embed's)."""
    jax, jax_gpt = _jax()
    jcfg = dataclasses.replace(jax_gpt.gpt_tiny(), num_layers=8)
    cfg = dataclasses.replace(port_gpt.gpt_tiny(), num_layers=8)
    params = jax_gpt.init_gpt(jax.random.PRNGKey(0), jcfg)
    mine = _port(params)
    for pp, vpp in ((2, 2), (2, None), (4, None)):
        want = _flat(jax.tree.map(np.asarray, jax_gpt.gpt_to_pipeline_params(
            params, jcfg, pp, vpp)))
        got = _flat(port_gpt.gpt_to_pipeline_params(mine, cfg, pp, vpp))
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), want[k])
    got = port_gpt.gpt_to_pipeline_params(mine, cfg, 2, 2)
    # chunk 3 (lane 1, rank 1) holds layers 6 and 7
    flat = mine["layers"]["fc1"]["kernel"]
    assert torch.equal(got["stages"]["fc1"]["kernel"][1, 1, 0], flat[6])
    assert torch.equal(got["stages"]["fc1"]["kernel"][1, 1, 1], flat[7])
    assert got["head"]["word"]["embedding"].data_ptr() != \
        got["embed"]["word"]["embedding"].data_ptr()
    with pytest.raises(ValueError, match="not divisible by 3"):
        port_gpt.gpt_to_pipeline_params(mine, cfg, 3)


@pytest.mark.parametrize("vpp", [None, 2])
@pytest.mark.parametrize("rope", [False, True])
def test_pipeline_partition_specs_match_jax(vpp, rope):
    jax, jax_gpt = _jax()
    from jax.sharding import PartitionSpec as JP

    want = jax_gpt.gpt_pipeline_partition_specs(_jcfg(rope), vpp)
    got = port_gpt.gpt_pipeline_partition_specs(_cfg(rope), vpp)
    leaves = jax.tree_util.tree_flatten_with_path(
        want, is_leaf=lambda x: isinstance(x, JP))[0]
    want = {tuple(k.key for k in path): tuple(spec)
            for path, spec in leaves}
    got = {k: tuple(v) for k, v in _flat(got).items()}
    assert got == want

"""Port parity of ``transformer/pipeline_parallel`` (the microbatch
calculator, the pipe exchanges and the three schedules) against the JAX
package on the CPU.

The reference's ``test_pipeline_parallel.py`` cases on its toy
``PipelineModel`` (embedding, LN-MLP stages, a softmax head), the JAX
``_init`` and ``_batch`` draws carried across as numpy: 1F1B at pp 2 (M
4) and pp 4 (M 8), interleaving at pp 2 with vpp 2 (M 4), each in pp
gloo ranks (``tests/_torch_ranks.py``) inside the port's
``parallel_state.shard_map``, against the JAX package's no-pipelining
golden model and against the JAX schedule on the same mesh (loss 1e-5,
gradients 1e-5 absolute and 1e-4 relative, the reference's); the port's
own no-pipelining run against both. Also ``forward_only``, the
calculator's count, the dispatcher, the lone send/recv fail-fast, fp32
accumulation against bf16, and the memory bound (the reference's
``test_pipeline_memory.py``): a stage holds at most ``2pp - 1`` saved
inputs at any tick, ``min(M, 2(pp-1-d) + 1)`` on stage d, at M 4 and M
16.
This module imports no JAX at its top (the ranks import it again)."""

import functools
import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from _torch_ranks import spawn
from apex_tpu_torch.transformer import parallel_state as ps
from apex_tpu_torch.transformer.pipeline_parallel import (
    PipelineModel, forward_backward_no_pipelining,
    forward_backward_pipelining_with_interleaving,
    forward_backward_pipelining_without_interleaving,
    get_forward_backward_func, microbatches, p2p_communication, schedules,
)

P = ps.PartitionSpec
VOCAB, SEQ, HIDDEN, FF = 64, 8, 16, 32
# (pp, vpp, M, init seed, batch seed): the reference's cases
CASES = {"1f1b_pp2": (2, None, 4, 0, 1), "1f1b_pp4": (4, None, 8, 0, 1),
         "interleaved_pp2_vpp2": (2, 2, 4, 2, 3)}
FWD_ONLY = (2, None, 4, 4, 5)
CALC = (2, None, 4, 6, 7)     # M from the calculator: global 8, micro 2
MEMORY_M = (4, 16)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the toy model, in torch (the reference test's functions)
# ---------------------------------------------------------------------------

def _embed_fn(p, mb):
    x = p["word"][mb["ids"]]
    return x + p["pos"][None, : x.shape[1]]


def _stage_fn(p, x):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    h = (x - mu) * torch.rsqrt(var + 1e-5) * p["ln_w"] + p["ln_b"]
    h = F.gelu(h @ p["fc1"] + p["b1"], approximate="tanh") @ p["fc2"] \
        + p["b2"]
    return x + h


def _loss_fn(p, x, mb):
    logp = torch.log_softmax(x @ p["proj"] + p["bias"], dim=-1)
    return -logp.gather(-1, mb["labels"][..., None])[..., 0].mean()


MODEL = PipelineModel(_embed_fn, _stage_fn, _loss_fn)


# ---------------------------------------------------------------------------
# the JAX side (memoized; imported lazily)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_rig():
    import importlib.util

    path = os.path.join(os.path.dirname(__file__), "L0", "run_transformer",
                        "test_pipeline_parallel.py")
    spec = importlib.util.spec_from_file_location("_jax_pp_rig", path)
    rig = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(rig)
    return rig


def _np_tree(tree):
    import jax
    return jax.tree.map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _jax_inputs(n_stages, init_seed, batch_seed, batch_size):
    import jax
    rig = _jax_rig()
    return (_np_tree(rig._init(jax.random.PRNGKey(init_seed), n_stages)),
            _np_tree(rig._batch(jax.random.PRNGKey(batch_seed), batch_size)))


def _case_inputs(case):
    pp, vpp, M, si, sb = case
    return _jax_inputs(pp * (vpp or 1), si, sb, 2 * M)


@functools.lru_cache(maxsize=None)
def _jax_golden(case):
    """The JAX no-pipelining loss and gradients (the reference's golden
    model)."""
    params, batch = _case_inputs(case)
    rig = _jax_rig()
    loss, grads = rig._reference(params, batch, case[2])
    return float(loss), _np_tree(grads)


@functools.lru_cache(maxsize=None)
def _jax_pipelined(case):
    """The JAX schedule's loss and gradients on a pp-device mesh (the
    interleaved stages reshaped back to (pp*vpp, ...))."""
    import jax
    from jax.sharding import PartitionSpec as JP

    from apex_tpu.transformer import parallel_state as jps
    from apex_tpu.transformer.pipeline_parallel import schedules as js

    pp, vpp, M, _, _ = case
    params, batch = _case_inputs(case)
    jps.initialize_model_parallel(
        pipeline_model_parallel_size_=pp,
        virtual_pipeline_model_parallel_size_=vpp,
        devices=jax.devices()[:pp])
    try:
        rig = _jax_rig()
        if vpp:
            params = dict(params, stages=jax.tree.map(
                lambda a: a.reshape((vpp, pp) + a.shape[1:]),
                params["stages"]))
            fn, sspec = js.forward_backward_pipelining_with_interleaving, \
                JP(None, jps.PIPE_AXIS)
        else:
            fn, sspec = js.forward_backward_pipelining_without_interleaving, \
                JP(jps.PIPE_AXIS)
        specs = {"embed": JP(), "stages": sspec, "head": JP()}
        loss, grads = jax.jit(jps.shard_map(
            lambda p, b: fn(rig.MODEL, p, b, num_microbatches=M),
            in_specs=(specs, JP()), out_specs=(JP(), specs)))(params, batch)
    finally:
        jps.destroy_model_parallel()
    grads = _np_tree(grads)
    if vpp:
        grads["stages"] = {k: v.reshape((pp * vpp,) + v.shape[2:])
                           for k, v in grads["stages"].items()}
    return float(loss), grads


def _torch_tree(tree):
    return {k: _torch_tree(v) if isinstance(v, dict)
            else torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _torch_batch(batch):
    return {k: torch.from_numpy(np.array(v)).long() for k, v in
            batch.items()}


# ---------------------------------------------------------------------------
# the port side, in each rank
# ---------------------------------------------------------------------------

def _pipelined(params, batch, pp, vpp, M, forward_only=False):
    """One pipelined run inside shard_map on a fresh mesh: (loss,
    gathered gradients or None, this rank's peak saved inputs)."""
    ps.destroy_model_parallel()
    ps.initialize_model_parallel(pipeline_model_parallel_size_=pp,
                                 virtual_pipeline_model_parallel_size_=vpp,
                                 device="cpu")
    if vpp:
        params = dict(params, stages={
            k: v.reshape((vpp, pp) + tuple(v.shape[1:]))
            for k, v in params["stages"].items()})
        fn, sspec = forward_backward_pipelining_with_interleaving, \
            P(None, ps.PIPE_AXIS)
    else:
        fn, sspec = forward_backward_pipelining_without_interleaving, \
            P(ps.PIPE_AXIS)
    specs = {"embed": P(), "stages": sspec, "head": P()}
    if forward_only:
        loss = ps.shard_map(
            lambda p, b: fn(MODEL, p, b, num_microbatches=M,
                            forward_only=True)[0],
            in_specs=(specs, P()), out_specs=P())(params, batch)
        return loss, None, schedules.peak_saved_inputs
    loss, grads = ps.shard_map(
        lambda p, b: fn(MODEL, p, b, num_microbatches=M),
        in_specs=(specs, P()), out_specs=(P(), specs))(params, batch)
    if vpp:
        grads["stages"] = {k: v.reshape((pp * vpp,) + tuple(v.shape[2:]))
                           for k, v in grads["stages"].items()}
    return loss, grads, schedules.peak_saved_inputs


def job(rank, world, tmp):
    d = torch.load(os.path.join(tmp, "inputs.pt"))
    out = {}
    for name, (pp, vpp, M, _, _) in CASES.items():
        if pp * (vpp or 1) > 1 and pp == world:
            params, batch = d[name]
            out[name] = _pipelined(params, batch, pp, vpp, M)
    params, batch = d["memory"]
    for M in MEMORY_M:
        out[("memory", M)] = _pipelined(params, batch[M], world, None, M)[2]
    if world == 2:
        params, batch = d["fwd_only"]
        out["fwd_only"] = _pipelined(params, batch, 2, None, 4, True)[0]
        params, batch = d["calc"]
        microbatches.setup_microbatch_calculator(
            rank=rank, rampup_batch_size=None, global_batch_size=8,
            micro_batch_size=2, data_parallel_size=1)
        try:
            out["calc_m"] = microbatches.get_num_microbatches()
            out["calc"] = _pipelined(params, batch, 2, None, None)[:2]
        finally:
            microbatches.destroy_num_microbatches_calculator()
        out["dispatch"] = []
        for pp, vpp in ((1, None), (2, None), (2, 2)):
            ps.destroy_model_parallel()
            ps.initialize_model_parallel(
                pipeline_model_parallel_size_=pp,
                virtual_pipeline_model_parallel_size_=vpp, device="cpu")
            out["dispatch"].append(get_forward_backward_func().__name__)
    return out


def _inputs_file(tmp, world):
    d = {}
    for name, case in CASES.items():
        params, batch = _case_inputs(case)
        d[name] = (_torch_tree(params), _torch_batch(batch))
    params, _ = _jax_inputs(world, 0, 1, 2)
    d["memory"] = (_torch_tree(params), {
        M: _torch_batch(_jax_inputs(world, 0, 1, 2 * M)[1])
        for M in MEMORY_M})
    for key, case in (("fwd_only", FWD_ONLY), ("calc", CALC)):
        params, batch = _case_inputs(case)
        d[key] = (_torch_tree(params), _torch_batch(batch))
    torch.save(d, os.path.join(tmp, "inputs.pt"))


@pytest.fixture(scope="module")
def w2(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pp2")
    _inputs_file(tmp, 2)
    return spawn(job, 2, tmp)


@pytest.fixture(scope="module")
def w4(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pp4")
    _inputs_file(tmp, 4)
    return spawn(job, 4, tmp)


# ---------------------------------------------------------------------------
# comparisons
# ---------------------------------------------------------------------------

def _flat(tree, path=()):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], path + (k,)))
        return out
    return {path: tree}


def _np(t):
    return t.detach().double().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float64)


def _held(loss, grads, want_loss, want_grads):
    np.testing.assert_allclose(float(loss), want_loss, atol=1e-5,
                               rtol=1e-5)
    got, want = _flat(grads), _flat(want_grads)
    assert got.keys() == want.keys()
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        np.testing.assert_allclose(_np(got[k]), want[k], atol=1e-5,
                                   rtol=1e-4, err_msg=str(k))


@pytest.mark.parametrize("name", sorted(CASES))
def test_schedule_matches_golden_and_jax_schedule(name, request):
    pp, vpp, M, _, _ = CASES[name]
    res = request.getfixturevalue(f"w{pp}")
    golden = _jax_golden(CASES[name])
    jax_sched = _jax_pipelined(CASES[name])
    for r in res:
        loss, grads, _ = r[name]
        _held(loss, grads, *golden)
        _held(loss, grads, *jax_sched)
    # every rank holds the same loss and gathered gradients
    g0 = _flat(res[0][name][1])
    for r in res[1:]:
        assert torch.equal(r[name][0], res[0][name][0])
        assert all(torch.equal(_flat(r[name][1])[k], g0[k]) for k in g0)


@pytest.mark.parametrize("name", sorted(CASES))
def test_no_pipelining_matches_jax(name):
    """The port's no-pipelining schedule, on one process with no mesh,
    against the JAX golden model."""
    params, batch = _case_inputs(CASES[name])
    loss, grads = forward_backward_no_pipelining(
        MODEL, _torch_tree(params), _torch_batch(batch),
        num_microbatches=CASES[name][2], checkpoint_stages=False)
    _held(loss, grads, *_jax_golden(CASES[name]))


def test_forward_only(w2):
    want, _ = _jax_golden(FWD_ONLY)
    for r in w2:
        np.testing.assert_allclose(float(r["fwd_only"]), want, atol=1e-5,
                                   rtol=1e-5)


def test_microbatch_count_from_calculator(w2):
    """``num_microbatches`` defaults to the global calculator's count
    (ref: ``get_num_microbatches``)."""
    want, want_grads = _jax_golden(CALC)
    for r in w2:
        assert r["calc_m"] == 4
        _held(*r["calc"], want, want_grads)


def test_dispatcher(w2):
    for r in w2:
        assert r["dispatch"] == [
            "forward_backward_no_pipelining",
            "forward_backward_pipelining_without_interleaving",
            "forward_backward_pipelining_with_interleaving"]


@pytest.mark.parametrize("world", [2, 4])
def test_saved_inputs_bounded_independent_of_m(world, request):
    """The ``deallocate_output_tensor`` property (ref:
    ``test_pipeline_memory.py``): stage d holds ``min(M, 2(pp-1-d) + 1)``
    saved inputs at most, never more than ``2pp - 1``: no more at M 16
    than at any M past ``2pp - 1``."""
    res = request.getfixturevalue(f"w{world}")
    for d, r in enumerate(res):
        held = [r[("memory", M)] for M in MEMORY_M]
        assert held == [min(M, 2 * (world - 1 - d) + 1) for M in MEMORY_M]
        assert max(held) <= 2 * world - 1


def test_no_pipelining_forward_only_matches_grad_path():
    params, batch = _jax_inputs(3, 8, 9, 4)
    params, batch = _torch_tree(params), _torch_batch(batch)
    l1, g = forward_backward_no_pipelining(MODEL, params, batch,
                                           num_microbatches=2)
    l2, none = forward_backward_no_pipelining(
        MODEL, params, batch, num_microbatches=2, forward_only=True)
    assert none is None
    np.testing.assert_allclose(float(l1), float(l2), atol=1e-6)
    assert all(t.shape == p.shape for t, p in zip(
        _flat(g).values(), _flat(params).values()))


def test_lone_send_recv_fail_fast():
    for fn in (p2p_communication.send_forward,
               p2p_communication.recv_forward,
               p2p_communication.send_backward,
               p2p_communication.recv_backward):
        with pytest.raises(RuntimeError, match="single collective"):
            fn(torch.ones(4))


def test_fp32_grad_accumulation_beats_bf16():
    """The ``gradient_accumulation_fusion`` analogue: bf16 microbatch
    gradients summed in fp32 keep the low bits a bf16 sum drops (the
    head's gradient is each microbatch's value; [256, 1, ..., 1] makes
    every bf16 +1 round away)."""
    model = PipelineModel(
        embed_fn=lambda e, mb: mb.to(torch.bfloat16),
        stage_fn=lambda sp, h: h + 0.0 * sp["w"].to(h.dtype),
        loss_fn=lambda head, x, mb: torch.sum(head["w"] * x).float())
    params = {"embed": {},
              "stages": {"w": torch.ones((1, 1), dtype=torch.bfloat16)},
              "head": {"w": torch.ones((1,), dtype=torch.bfloat16)}}
    batch = torch.cat([torch.tensor([256.0]), torch.ones(7)])
    _, g32 = forward_backward_no_pipelining(
        model, params, batch, num_microbatches=8, checkpoint_stages=False)
    _, gb16 = forward_backward_no_pipelining(
        model, params, batch, num_microbatches=8, checkpoint_stages=False,
        fp32_grad_accum=False)
    assert g32["head"]["w"].dtype == torch.float32
    assert gb16["head"]["w"].dtype == torch.bfloat16
    assert float(g32["head"]["w"][0]) == 32.875
    assert float(gb16["head"]["w"][0]) == 32.0


def test_rampup_calculator_matches_jax():
    """The ramp-up calculator's counts and global batch sizes over
    consumed samples, against the JAX package's."""
    from apex_tpu.transformer.pipeline_parallel import microbatches as jmb

    args = (16, 8, 1000, 64, 4, 2)
    mine = microbatches.RampupBatchsizeNumMicroBatches(*args)
    ref = jmb.RampupBatchsizeNumMicroBatches(*args)
    for consumed in (0, 100, 333, 500, 999, 1000, 1001, 5000):
        mine.update(consumed, False)
        ref.update(consumed, False)
        assert (mine.get(), mine.get_current_global_batch_size()) == \
            (ref.get(), ref.get_current_global_batch_size())
    microbatches.setup_microbatch_calculator(0, [16, 8, 1000], 64, 4, 2)
    try:
        microbatches.update_num_microbatches(600, consistency_check=True)
        ref.update(600, True)
        assert (microbatches.get_num_microbatches(),
                microbatches.get_current_global_batch_size()) == \
            (ref.get(), ref.get_current_global_batch_size())
    finally:
        microbatches.destroy_num_microbatches_calculator()
    with pytest.raises(ValueError, match="not divisible"):
        microbatches.ConstantNumMicroBatches(10, 4, 1)

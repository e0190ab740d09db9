"""Port parity of ``transformer/testing`` (the Megatron flag parser, the
args registry, the shared helpers and the standalone-model re-exports)
and of ``examples/gpt/pretrain_gpt.py``'s parallel flags, against the
JAX package on the CPU.

The rig's functions against the JAX rig's on the same arguments; then
``pretrain_gpt.main`` on two gloo ranks (``tests/_torch_ranks.py``) at
the reference's defaults with ``--pipeline-model-parallel-size 2`` (1F1B)
and with ``--virtual-pipeline-model-parallel-size 2`` too, at tp 2 with
``--sequence-parallel``, and at dp 2 with
``--use-distributed-optimizer``: each prints the reference CLI's step 0
and step 2 losses within 1e-5 (the JAX values as
``tests/test_torch_gpt_train.py`` computes them, on one device: the
step's mathematics does not depend on the split). The reference's
refusals stay: ``--context-parallel-size`` above 1, ZeRO beside pp above
1, a virtual pipeline size at pp 1. This module imports no JAX at its
top."""

import contextlib
import functools
import importlib
import io
import os

import numpy as np
import pytest
import torch

from _torch_ranks import spawn
from apex_tpu_torch.examples.gpt import pretrain_gpt
from apex_tpu_torch.models import bert as port_bert
from apex_tpu_torch.models import gpt as port_gpt
from apex_tpu_torch.transformer import parallel_state as ps
from apex_tpu_torch.transformer import testing
from apex_tpu_torch.transformer.testing import (
    arguments, commons, global_vars,
)

STEPS = ["--steps", "3"]
RUNS = {"pp2": ["--pipeline-model-parallel-size", "2"],
        "pp2_vpp2": ["--pipeline-model-parallel-size", "2",
                     "--virtual-pipeline-model-parallel-size", "2"],
        "tp2_sp": ["--tensor-model-parallel-size", "2",
                   "--sequence-parallel"],
        "dp2_zero": ["--use-distributed-optimizer"]}
REFUSED = {"cp2": ["--context-parallel-size", "2"],
           "zero_pp2": ["--pipeline-model-parallel-size", "2",
                        "--use-distributed-optimizer"],
           "vpp_pp1": ["--virtual-pipeline-model-parallel-size", "2"]}
ARGVS = [[], ["--tensor-model-parallel-size", "2", "--sequence-parallel",
              "--unknown-flag", "3"],
         ["--pipeline-model-parallel-size", "4",
          "--virtual-pipeline-model-parallel-size", "2", "--num-layers", "8",
          "--bf16", "--lr", "3e-4"]]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_rig():
    from apex_tpu.transformer import testing as jtesting
    from apex_tpu.transformer.testing import arguments as jargs
    from apex_tpu.transformer.testing import commons as jcommons
    from apex_tpu.transformer.testing import global_vars as jgv
    return jtesting, jargs, jcommons, jgv


@pytest.mark.parametrize("argv", ARGVS, ids=["defaults", "tp_sp", "vpp"])
def test_parse_args_matches_jax(argv):
    _, jargs, _, _ = _jax_rig()
    assert vars(arguments.parse_args(args=argv)) == \
        vars(jargs.parse_args(args=argv))

    def extra(p):
        p.add_argument("--steps", type=int, default=10)
        return p

    assert vars(arguments.parse_args(extra, argv + ["--steps", "2"])) == \
        vars(jargs.parse_args(extra, argv + ["--steps", "2"]))
    with pytest.raises(SystemExit):
        arguments.parse_args(args=["--nope"], ignore_unknown_args=False)


def test_global_vars_registry_matches_jax():
    _, _, _, jgv = _jax_rig()
    for mod in (global_vars, jgv):
        mod.unset_args()
        assert not mod.args_are_set()
    with pytest.raises(RuntimeError) as mine:
        global_vars.get_args()
    with pytest.raises(RuntimeError) as ref:
        jgv.get_args()
    assert str(mine.value) == str(ref.value)
    ns = arguments.parse_args(args=[])
    testing.set_args(ns)
    try:
        assert testing.get_args() is ns and global_vars.args_are_set()
    finally:
        global_vars.unset_args()


def test_standalone_models_are_the_port_zoo():
    jtesting, _, _, _ = _jax_rig()
    names = ["BertConfig", "apply_bert", "bert_tiny", "init_bert",
             "GPTConfig", "GPTModel", "gpt_pipeline_model", "gpt_tiny",
             "init_gpt"]
    for name in names:
        assert hasattr(jtesting, name)
        mod = port_bert if "ert" in name else port_gpt
        assert getattr(testing, name) is getattr(mod, name)


def test_commons_match_jax(capsys):
    _, _, jcommons, _ = _jax_rig()
    from apex_tpu.transformer.tensor_parallel import random as jrandom

    from apex_tpu_torch.transformer.tensor_parallel import random as prandom

    key = commons.set_random_seed(5)
    jkey = jcommons.set_random_seed(5)
    assert key.tolist() == np.asarray(jkey).tolist()
    mine = prandom.get_rng_tracker().get_states()
    ref = jrandom.get_rng_tracker().get_states()
    assert mine.keys() == ref.keys() == {"model-parallel-rng"}
    commons.print_separator("x")
    jcommons.print_separator("x")
    out = capsys.readouterr().out
    half = len(out) // 2
    assert out[:half] == out[half:] and " x " in out


@pytest.fixture
def world_of_one():
    import torch.distributed as dist

    yield
    ps.destroy_model_parallel()
    if dist.is_initialized():
        dist.destroy_process_group()


def test_initialize_from_args_matches_jax(world_of_one):
    """A world of one on the CPU: the mesh's axes from the flags, as the
    JAX rig's on one device; a virtual pipeline at pp 1 is refused with
    the reference's message."""
    import jax

    _, jargs, _, _ = _jax_rig()
    from apex_tpu.transformer import parallel_state as jps

    ns = arguments.parse_args(args=[])
    mesh = arguments.initialize_from_args(ns, device="cpu")
    try:
        jps.initialize_model_parallel(devices=jax.devices()[:1])
        jmesh = jps.get_mesh()
        assert mesh.shape == dict(zip(jmesh.axis_names,
                                      jmesh.devices.shape))
    finally:
        jps.destroy_model_parallel()
    bad = arguments.parse_args(
        args=["--virtual-pipeline-model-parallel-size", "2"])
    with pytest.raises(ps.ParallelStateError,
                       match="requires pipeline_model_parallel_size >= 2"):
        arguments.initialize_from_args(bad, device="cpu")
    assert commons.initialize_distributed(device="cpu").shape == mesh.shape


# ---------------------------------------------------------------------------
# pretrain_gpt.main on two gloo ranks
# ---------------------------------------------------------------------------

def _main(argv):
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            rc = pretrain_gpt.main(argv + ["--device", "cpu"])
    except (SystemExit, ps.ParallelStateError) as e:
        return ("raised", type(e).__name__, str(e))
    return rc, buf.getvalue()


def job(rank, world, tmp):
    out = {name: _main(argv + STEPS) for name, argv in RUNS.items()}
    out.update({name: _main(argv) for name, argv in REFUSED.items()})
    return out


@pytest.fixture(scope="module")
def w2(tmp_path_factory):
    return spawn(job, 2, tmp_path_factory.mktemp("pretrain2"))


@functools.lru_cache(maxsize=None)
def _jax_losses():
    gt = importlib.import_module("test_torch_gpt_train")
    return gt._jax_cli_losses(STEPS)


def _losses(text):
    return {int(ln.split()[1]): float(ln.split()[3])
            for ln in text.splitlines() if ln.startswith("step ")}


@pytest.mark.parametrize("name", sorted(RUNS))
def test_pretrain_gpt_parallel_runs_match_the_reference_cli(name, w2):
    want = _jax_losses()
    rc, text = w2[0][name]
    assert rc == 0 and w2[1][name] == (0, "")   # rank 0 prints
    lines = text.strip().splitlines()
    pp = 2 if name.startswith("pp2") else 1
    tp = 2 if name.startswith("tp2") else 1
    assert lines[0] == f"mesh: dp={2 // (pp * tp)} tp={tp} pp={pp}"
    assert lines[-1] == "DONE"
    got = _losses(text)
    assert got.keys() == want.keys() == {0, 2}
    for i in want:
        assert abs(got[i] - want[i]) <= 1e-5, (i, got[i], want[i])


def test_pretrain_gpt_keeps_the_reference_refusals(w2):
    """The reference's refusals, on both ranks: context parallelism in
    the script and ZeRO beside pp above 1 stop with its messages; a
    virtual pipeline at pp 1 is refused by the mesh."""
    for r in w2:
        assert r["cp2"][1] == "SystemExit" and r["cp2"][2].startswith(
            "this script does not drive context parallelism")
        assert r["zero_pp2"][1] == "SystemExit" and r["zero_pp2"][
            2].startswith("--use-distributed-optimizer composes with pure "
                          "data")
        assert r["vpp_pp1"][1] == "ParallelStateError" and \
            "requires pipeline_model_parallel_size >= 2" in r["vpp_pp1"][2]

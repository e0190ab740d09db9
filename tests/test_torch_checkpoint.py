"""Port parity of ``utils/checkpoint.py`` and the imagenet example's
``--checkpoint`` / ``--save-freq`` / ``--resume`` (the JAX package's
``tests/L0/run_examples/test_resume.py``), on the CPU.

Atomic writes (an overwrite through the rename, no ``.tmp`` left, also
when the write raises); a bf16 leaf, a NamedTuple state and Python and
numpy scalars round-trip bit for bit, against the JAX package's
``save_checkpoint`` / ``load_checkpoint`` of the same tree; the
kill-and-resume case on the port's ``main(argv)`` in this process (``-a
resnet10 --image-size 32 --num-classes 10 -b 8 --print-freq 1
--opt-level O2``) in both ``--flat-kernel`` modes: six straight steps
against three steps and a resume to six, the printed losses of steps
3-5 equal as strings; a resume past ``--steps`` has nothing to do; a
flat momentum buffer whose rows do not match the params' layout is
refused."""

import os
import re
from typing import NamedTuple

import numpy as np
import pytest
import torch

from apex_tpu_torch.examples.imagenet import main_amp
from apex_tpu_torch.optimizers import FusedSGD
from apex_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint

ARGS = ["--device", "cpu", "-a", "resnet10", "--image-size", "32",
        "--num-classes", "10", "-b", "8", "--print-freq", "1",
        "--opt-level", "O2"]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _State(NamedTuple):
    step: torch.Tensor
    m: dict


def test_checkpoint_atomicity(tmp_path):
    """The reference's case: bf16 kept, an overwrite through the rename,
    no temp file left."""
    path = str(tmp_path / "t.ckpt")
    tree = {"a": torch.arange(5, dtype=torch.bfloat16),
            "b": [torch.tensor(1.5), np.int32(7)]}
    save_checkpoint(path, tree)
    out = load_checkpoint(path)
    assert out["a"].dtype == torch.bfloat16
    assert torch.equal(out["a"], torch.arange(5, dtype=torch.bfloat16))
    assert out["b"][1] == 7 and isinstance(out["b"][1], np.int32)
    save_checkpoint(path, {"a": torch.zeros(3)})
    assert torch.equal(load_checkpoint(path)["a"], torch.zeros(3))
    assert [p for p in os.listdir(tmp_path) if p.endswith(".tmp")] == []


def test_failed_write_leaves_the_old_file(tmp_path):
    """A write that raises leaves the previous checkpoint as it was and
    no temp file."""
    path = str(tmp_path / "t.ckpt")
    save_checkpoint(path, {"a": torch.ones(2)})
    with pytest.raises(Exception):
        save_checkpoint(path, {"a": torch.zeros(2), "bad": lambda: 0})
    assert torch.equal(load_checkpoint(path)["a"], torch.ones(2))
    assert [p for p in os.listdir(tmp_path) if p.endswith(".tmp")] == []


def test_round_trip_matches_the_jax_package(tmp_path):
    """A bf16 leaf, a NamedTuple and scalars come back with the same
    bits, structure and types, as the JAX package's checkpoint gives
    back the same tree (bf16 compared as its 16 bits)."""
    import jax.numpy as jnp

    from apex_tpu.utils.checkpoint import (
        load_checkpoint as jload, save_checkpoint as jsave,
    )

    rng = np.random.default_rng(0)
    w = rng.standard_normal((4, 8)).astype(np.float32)
    tree = _State(step=torch.tensor(3, dtype=torch.int32),
                  m={"w": torch.from_numpy(w).to(torch.bfloat16),
                     "s": [2.5, np.float32(0.25)]})
    save_checkpoint(str(tmp_path / "p.ckpt"), tree)
    got = load_checkpoint(str(tmp_path / "p.ckpt"))
    assert type(got) is _State and got.step.dtype == torch.int32
    assert got.m["w"].dtype == torch.bfloat16 and not got.m["w"].is_cuda
    assert torch.equal(got.m["w"].view(torch.int16),
                       tree.m["w"].view(torch.int16))
    assert got.m["s"] == [2.5, np.float32(0.25)]
    assert isinstance(got.m["s"][1], np.float32)

    jsave(str(tmp_path / "j.ckpt"),
          {"step": jnp.int32(3), "w": jnp.asarray(w, jnp.bfloat16)})
    jgot = jload(str(tmp_path / "j.ckpt"))
    np.testing.assert_array_equal(
        np.asarray(jgot["w"]).view(np.uint16),
        got.m["w"].view(torch.int16).numpy().view(np.uint16))
    assert int(jgot["step"]) == int(got.step)


def _run(args, capsys):
    assert main_amp.main(ARGS + args) == 0
    out = capsys.readouterr().out
    return out, {int(m.group(1)): m.group(2) for m in re.finditer(
        r"step\s+(\d+)\s+loss (\d+\.\d+)", out)}


@pytest.mark.parametrize("flat", [False, True], ids=["tree", "flat"])
def test_kill_and_resume_reproduces_loss_curve(flat, tmp_path, capsys):
    """Six straight steps against three, then a resume to six from the
    file the three left: the resumed run starts at step 3 and prints the
    straight run's losses, as strings."""
    extra = ["--flat-kernel"] if flat else []
    ck_a, ck_b = str(tmp_path / "a.ckpt"), str(tmp_path / "b.ckpt")
    _, straight = _run(["--steps", "6", "--checkpoint", ck_a] + extra,
                       capsys)
    _run(["--steps", "3", "--checkpoint", ck_b] + extra, capsys)
    ck = load_checkpoint(ck_b)
    assert int(ck["step"]) == 2
    buf = ck["opt_state"].momentum_buf
    assert isinstance(buf, torch.Tensor) == flat
    out, resumed = _run(["--steps", "6", "--checkpoint", ck_b,
                         "--resume", ck_b] + extra, capsys)
    assert f"resumed from {ck_b} at step 3" in out
    assert set(resumed) == {3, 4, 5}
    for s in (3, 4, 5):
        assert resumed[s] == straight[s], (s, resumed[s], straight[s])
    assert int(load_checkpoint(ck_b)["step"]) == 5


def test_resume_past_the_end_and_a_foreign_buffer(tmp_path, capsys):
    """A resumed step at or past ``--steps`` has nothing to do; a flat
    momentum buffer of another layout is refused."""
    ck = str(tmp_path / "c.ckpt")
    _run(["--steps", "2", "--checkpoint", ck, "--flat-kernel"], capsys)
    out, losses = _run(["--steps", "2", "--resume", ck, "--flat-kernel"],
                       capsys)
    assert "nothing to do: resumed step 2 >= --steps 2" in out
    assert losses == {}
    tree = load_checkpoint(ck)
    st = tree["opt_state"]
    tree["opt_state"] = st._replace(momentum_buf=st.momentum_buf[:-8])
    save_checkpoint(ck, tree)
    with pytest.raises(ValueError, match="momentum buffer"):
        main_amp.resume_state(ck, FusedSGD(lr=0.1, use_flat_kernel=True),
                              tree["params"], torch.device("cpu"))

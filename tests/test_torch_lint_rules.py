"""The port's apxlint rules in the torch idiom (``apex_tpu_torch.lint``):
every code of the AST tiers fires on its known-bad fixture and stays
silent on its known-clean twin (``tests/torch_lint_fixtures``), and —
the load-bearing part — fires on the bug class it exists for, seeded
into a scratch copy of the real port module:

- APX106: a bf16 operand in ``quant.kernels.w8_matmul_plain``; a
  truncating int8 cast in ``quant.params.quantize_tensor``;
- APX201: ``collective("all_reduce", ...)`` under ``if dist.get_rank()
  == 0:`` in ``tensor_parallel.mappings._all_reduce``; the page
  handoff's receive taken out of ``serving.transfer.Wire.move`` and out
  of the cross-process ``PageTransfer._cross``;
- APX202: a ring shift over a misspelt axis in ``context_parallel``;
- APX301-304: the op lists of ``amp/lists.py`` against the
  ``cast_args`` sites, on a scratch copy of the package's amp tree;
- APX401/402: host reads and global writes under CUDA-graph capture,
  ``torch.compile`` and activation checkpointing, roots resolved across
  modules; a host read seeded into GPT's checkpointed block.

Everything here reads source; nothing is imported from the linted
files."""

import os
import shutil

import pytest

from apex_tpu_torch.lint.engine import lint_paths

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "apex_tpu_torch")
FIXTURES = os.path.join(REPO, "tests", "torch_lint_fixtures")

#: fixture -> the (code, line) findings it must give
BAD = {
    "apx106_bad.py": [("APX106", 15), ("APX106", 16), ("APX106", 20),
                      ("APX106", 24), ("APX106", 29)],
    "apx201_bad.py": [("APX201", 12), ("APX201", 18), ("APX201", 28)],
    "apx202_bad.py": [("APX202", 9), ("APX202", 14), ("APX202", 14)],
    "apx401_bad.py": [("APX401", 20), ("APX401", 27), ("APX401", 34),
                      ("APX401", 41), ("APX401", 45)],
    "apx402_bad.py": [("APX402", 10)],
}
CLEAN = ("apx106_clean.py", "apx201_clean.py", "apx202_clean.py",
         "apx401_clean.py", "suppressed.py", "suppressed_file.py")


def _lint(*paths, **kw):
    kw.setdefault("include_fixtures", True)
    findings, _ = lint_paths([str(p) for p in paths], **kw)
    return findings


@pytest.mark.parametrize("name", sorted(BAD))
def test_bad_fixture_fires(name):
    got = [(f.code, f.line) for f in _lint(os.path.join(FIXTURES, name))]
    assert got == BAD[name]


@pytest.mark.parametrize("name", CLEAN)
def test_clean_fixture_is_silent(name):
    assert _lint(os.path.join(FIXTURES, name)) == []


def test_apx106_messages_name_the_contract():
    msgs = [f.message for f in _lint(os.path.join(FIXTURES,
                                                  "apx106_bad.py"))]
    assert "scale 'k_scale'" in msgs[0] and "scale 'v_scale'" in msgs[1]
    assert "x.bfloat16()" in msgs[2] and "'w8_matmul'" in msgs[2]
    assert "operand(s) x " in msgs[3] and "'dequant_linear'" in msgs[3]
    assert "no rounding call" in msgs[4]


def test_apx201_messages():
    msgs = [f.message for f in _lint(os.path.join(FIXTURES,
                                                  "apx201_bad.py"))]
    assert "all_reduce" in msgs[0]
    assert "dist.all_reduce,dist.broadcast" in msgs[1]
    assert "send on group group" in msgs[2] and "one-sided" in msgs[2]


def test_amp_list_coherence():
    findings = _lint(os.path.join(FIXTURES, "amp_bad"))
    assert sorted(f.code for f in findings) == [
        "APX301", "APX302", "APX303", "APX304"]
    by_code = {f.code: f for f in findings}
    assert "matmul" in by_code["APX301"].message
    assert "bmm" in by_code["APX302"].message
    assert by_code["APX302"].path.endswith("ops.py")
    assert "softmax" in by_code["APX303"].message
    assert "linear" in by_code["APX304"].message
    assert _lint(os.path.join(FIXTURES, "amp_clean")) == []


def test_apx401_roots_cross_modules():
    """``tp_random.checkpoint(block, x)`` in ranks.py roots ``block`` in
    blocks.py (its host read fires there); ``helper``, called but never
    rooted, stays clean; blocks.py alone is clean."""
    root = os.path.join(FIXTURES, "apx401_cross")
    findings = _lint(root)
    assert [(f.code, os.path.basename(f.path), f.line)
            for f in findings] == [("APX401", "blocks.py", 9)]
    assert _lint(os.path.join(root, "apex_tpu_torch", "blocks.py")) == []


def test_apx401_clean_on_the_ports_roots():
    """The port's own roots — GPT's and BERT's checkpointed blocks, the
    context-parallel and pipeline recomputes, the MLP's, and
    chip_smoke.py's CUDA-graph captures — read no host state."""
    paths = [os.path.join(PORT, p) for p in (
        "models/gpt.py", "models/bert.py", "mlp/mlp.py",
        "transformer/context_parallel.py",
        "transformer/pipeline_parallel/schedules.py",
        "transformer/tensor_parallel/mappings.py")]
    assert _lint(*paths, os.path.join(REPO, "chip_smoke.py"),
                 select=("APX4",)) == []


# ---------------------------------------------------------------------------
# seeded bugs in scratch copies of the real modules
# ---------------------------------------------------------------------------

def _scratch(tmp_path, rel):
    """A copy of ``apex_tpu_torch/<rel>`` (a file) under ``tmp_path``."""
    dst = tmp_path / "apex_tpu_torch" / rel
    dst.parent.mkdir(parents=True, exist_ok=True)
    shutil.copy(os.path.join(PORT, rel), dst)
    return dst


def _mutate(path, old, new):
    src = path.read_text()
    assert src.count(old) == 1, f"mutation anchor drifted: {old!r}"
    path.write_text(src.replace(old, new))
    return src[:src.index(old)].count("\n") + 1


def _seeded(tmp_path, rel, old, new, code, at=None):
    """Baseline clean for ``code``, then exactly one finding of it: at
    the mutated line, or at the first line after it holding ``at``."""
    dst = _scratch(tmp_path, rel)
    assert _lint(dst, select=(code,)) == []
    line = _mutate(dst, old, new)
    if at is not None:
        lines = dst.read_text().splitlines()
        line += next(i for i, text in enumerate(lines[line - 1:])
                     if at in text)
    findings = _lint(dst, select=(code,))
    assert [(f.code, f.line) for f in findings] == [(code, line)], \
        [f.render() for f in findings]
    return findings[0]


def test_seeded_bf16_operand_in_w8_matmul_plain(tmp_path):
    f = _seeded(tmp_path, "quant/kernels.py",
                "y = torch.matmul(x2.float(), _dequant(wq, scale, False))",
                "y = torch.matmul(x2.bfloat16(), _dequant(wq, scale, "
                "False))", "APX106")
    assert "'w8_matmul_plain'" in f.message


def test_seeded_truncating_quantize(tmp_path):
    f = _seeded(tmp_path, "quant/params.py",
                "q = torch.round(fw / safe.unsqueeze(axis)).clamp(-127, 127)",
                "q = (fw / safe.unsqueeze(axis)).clamp(-127, 127)", "APX106",
                at=".to(torch.int8)")
    assert "'quantize_tensor'" in f.message


def test_seeded_rank_dependent_all_reduce(tmp_path):
    f = _seeded(tmp_path, "transformer/tensor_parallel/mappings.py",
                "    group, members, _ = _tp()\n"
                "    return collective(\"all_reduce\", x, group, members, "
                "op=op)\n",
                "    group, members, _ = _tp()\n"
                "    if dist.get_rank() == 0:\n"
                "        return collective(\"all_reduce\", x, group, "
                "members, op=op)\n"
                "    return x\n", "APX201", at="if dist.get_rank() == 0:")
    assert "all_reduce" in f.message


def test_seeded_one_sided_handoff(tmp_path):
    """The handoff's ``Wire.move`` sends on the source rank and receives
    on the destination: taking the receive out leaves the send one-sided
    (the send's rank split is the mutated line's ``if``)."""
    dst = _scratch(tmp_path, "serving/transfer.py")
    assert _lint(dst, select=("APX201",)) == []
    _mutate(dst, "            out = self.recv(t.shape, t.dtype, src)"
                 ".to(device)\n",
            "            out = t.to(device)\n")
    findings = _lint(dst, select=("APX201",))
    assert len(findings) == 1 and "one-sided" in findings[0].message
    lines = dst.read_text().splitlines()
    assert "if self.rank == src:" in lines[findings[0].line - 1]


def test_seeded_one_sided_cross_process_ship(tmp_path):
    """``PageTransfer._cross`` sends the tiles under the source ranks'
    test and receives them under the destination ranks' (two splits,
    paired within the function): taking the receive out leaves the send
    one-sided."""
    dst = _scratch(tmp_path, "serving/transfer.py")
    _mutate(dst, "            k_tile, v_tile, digest = "
                 "wire.recv_tiles(src[0])\n",
            "            k_tile = v_tile = digest = None\n")
    findings = _lint(dst, select=("APX201",))
    assert len(findings) == 1 and "send on group self.group" in \
        findings[0].message
    lines = dst.read_text().splitlines()
    assert lines[findings[0].line - 1].strip().startswith("if me ")


def test_seeded_misspelt_axis(tmp_path):
    dst = _scratch(tmp_path, "transformer/context_parallel.py")
    src = dst.read_text()
    assert "ps.CONTEXT_AXIS" in src
    assert _lint(dst, select=("APX202",)) == []
    dst.write_text(src.replace("ps.CONTEXT_AXIS", '"ctx"'))
    findings = _lint(dst, select=("APX202",))
    assert findings and all("'ctx'" in f.message for f in findings)


def test_seeded_stale_unwired_op(tmp_path):
    """Wiring an op the package's ``amp/lists.py`` declares UNWIRED makes
    the exemption stale (APX304); dropping a wired op from its list
    leaves the call site unlisted (APX302)."""
    for dirpath, _, files in os.walk(PORT):   # the lists and every site
        for f in files:
            path = os.path.join(dirpath, f)
            if f == "lists.py" or (f.endswith(".py") and "cast_args(\""
                                   in open(path).read()):
                _scratch(tmp_path, os.path.relpath(path, PORT))
    amp = tmp_path / "apex_tpu_torch"
    assert _lint(amp) == []
    (amp / "amp" / "extra.py").write_text(
        "from apex_tpu_torch.amp.autocast import cast_args\n\n\n"
        "def bmm(a, b):\n    return cast_args(\"bmm\", a, b)\n")
    assert [f.code for f in _lint(amp)] == ["APX304"]
    _mutate(amp / "amp" / "lists.py", '"dense",\n    "bmm", "mm"',
            '"dense",\n    "mm"')   # bmm out of FP16_FUNCS
    assert sorted(f.code for f in _lint(amp)) == ["APX302", "APX304"]


def test_seeded_host_read_in_gpts_checkpointed_block(tmp_path):
    """GPT's layer ``block`` is recomputed by ``checkpoint``: a host read
    seeded into it fires APX401 there."""
    dst = _scratch(tmp_path, "models/gpt.py")
    src = dst.read_text()
    assert "\n    def block(" in src
    assert _lint(dst, select=("APX4",)) == []
    body = src.index("\n    def block(")
    colon = src.index(":\n", body) + 2
    dst.write_text("import time\n" + src[:colon]
                   + "        _ = time.time()\n" + src[colon:])
    findings = _lint(dst, select=("APX4",))
    assert [f.code for f in findings] == ["APX401"]
    assert "'block'" in findings[0].message

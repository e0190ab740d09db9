"""The port's apxlint (``apex_tpu_torch.lint``) against the JAX package's
(``apex_tpu.lint``) on the CPU: the engine, the CLI, the catalogue, the
helpers, and the run over the port itself.

- Where a rule is language-neutral (the AMP op lists, suppression
  comments, set ordering and wall clocks, raise closure, observe names,
  the jax.random key idiom that the port's ``prng`` keeps), both
  checkers run on the JAX package's own fixtures and give the same
  ``(code, file, line)`` list. ``parse_suppressions``,
  ``parse_file_suppressions``, ``collect_files`` and the ``astutil``
  helpers give the same results on the same inputs.
- The fixtures in the JAX idiom (``pallas_call``, ``lax.psum``,
  ``jax.jit`` roots) are not the port's idiom: the port's rules read
  torch (``tests/test_torch_lint_rules.py``), so there the two differ by
  design, and this file checks that they do.
- ``python -m apex_tpu_torch.lint apex_tpu_torch tests/test_torch_*.py
  chip_smoke.py --determinism`` is clean, and the lint imports neither
  torch nor jax.

The JAX package's lint tiers imported here are its AST tiers, which
import no JAX."""

import ast
import glob
import os
import re
import subprocess
import sys

import pytest

from apex_tpu.lint import CODES as REF_CODES
from apex_tpu.lint import astutil as ref_astutil
from apex_tpu.lint import engine as ref_engine
from apex_tpu_torch.lint import CODES, PENDING, Finding
from apex_tpu_torch.lint import astutil
from apex_tpu_torch.lint import engine
from apex_tpu_torch.lint.__main__ import main

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_FIXTURES = os.path.join(REPO, "tests", "L0", "run_lint", "fixtures")
FIXTURES = os.path.join(REPO, "tests", "torch_lint_fixtures")

#: the reference's fixtures whose rules read no JAX idiom
NEUTRAL = ("amp_bad", "amp_clean", "suppressed.py", "suppressed_file.py",
           "determinism/serving/apx801_bad.py",
           "determinism/serving/apx801_clean.py",
           "determinism/serving/apx803_bad.py",
           "determinism/serving/apx803_clean.py",
           "determinism/serving/apx805_bad.py",
           "determinism/serving/apx805_clean.py",
           "determinism/serving/suppressed_det.py",
           "determinism/apx804_bad", "determinism/apx804_clean")
#: the reference's fixtures in the JAX idiom, and the codes each fires
JAX_IDIOM = {"apx106_bad.py": "APX106", "apx201_bad.py": "APX201",
             "apx202_bad.py": "APX202", "apx401_bad.py": "APX401",
             "apx402_bad.py": "APX402",
             "apx401_hoststate_bad.py": "APX401"}


def _triples(findings):
    return [(f.code, os.path.relpath(f.path, REPO), f.line)
            for f in findings]


def _both(paths):
    kw = dict(trace=False, determinism=True, include_fixtures=True)
    ref, n_ref = ref_engine.lint_paths(paths, **kw)
    port, n_port = engine.lint_paths(paths, **kw)
    assert n_ref == n_port
    return _triples(ref), _triples(port)


@pytest.mark.parametrize("name", NEUTRAL)
def test_neutral_fixtures_give_the_references_findings(name):
    ref, port = _both([os.path.join(REF_FIXTURES, name)])
    assert port == ref
    if name.endswith("_bad.py") or name.endswith("_bad"):
        assert port, "a bad fixture must fire"


@pytest.mark.parametrize("name", sorted(JAX_IDIOM))
def test_jax_idiom_fixtures_are_not_the_ports(name):
    """The reference fires on its JAX-idiom fixture; the port, reading
    torch, does not: its twin in the torch idiom lives under
    ``tests/torch_lint_fixtures``."""
    ref, port = _both([os.path.join(REF_FIXTURES, name)])
    assert {c for c, _, _ in ref} == {JAX_IDIOM[name]}
    assert port == []


def test_codes_keep_the_references_catalogue():
    """Every code of the JAX package's checker stays in the catalogue,
    so a suppression comment naming one stays valid; the codes of the
    tiers not ported name their queue item."""
    assert set(CODES) == set(REF_CODES)
    assert all(CODES[c] for c in CODES)
    ported = set(CODES) - set(PENDING)
    assert ported == {"APX100", "APX106", "APX201", "APX202", "APX301",
                      "APX302", "APX303", "APX304", "APX401", "APX402",
                      "APX801", "APX802", "APX803", "APX804", "APX805"}
    for code, item in PENDING.items():
        assert CODES[code].startswith(f"not yet ported ({item})")
        assert item in ("A8.2", "A8.3", "A8.4", "A8.5")


def test_finding_renders_as_the_references():
    from apex_tpu.lint import Finding as RefFinding

    f = Finding("APX801", "a/b.py", 3, "msg")
    assert f.render() == RefFinding("APX801", "a/b.py", 3, "msg").render()


def _fixture_sources():
    out = []
    for root in (REF_FIXTURES, FIXTURES):
        for dirpath, _, files in os.walk(root):
            out += [os.path.join(dirpath, f) for f in sorted(files)
                    if f.endswith(".py")]
    return sorted(out)


@pytest.mark.parametrize("fn", ["parse_suppressions",
                                "parse_file_suppressions"])
def test_suppression_parsing_matches_the_reference(fn):
    texts = [open(p).read() for p in _fixture_sources()]
    texts.append("x = 1  # apxlint: disable=APX101, APX801\n"
                 "# apxlint: disable=APX106\ny = 2\n"
                 "    # apxlint: disable-file=APX401,APX402\n")
    for src in texts:
        assert getattr(engine, fn)(src) == getattr(ref_engine, fn)(src)


@pytest.mark.parametrize("include", [False, True])
def test_collect_files_matches_the_reference(include):
    for roots in ([REF_FIXTURES], [FIXTURES],
                  [os.path.join(REPO, "apex_tpu_torch", "lint"),
                   os.path.join(REF_FIXTURES, "apx106_bad.py")]):
        assert engine.collect_files(roots, include) == \
            ref_engine.collect_files(roots, include)
    assert engine.collect_files([FIXTURES]) == []   # every one is marked


def _norm(value):
    if isinstance(value, ast.AST):
        return ast.dump(value)
    if isinstance(value, list):
        return [_norm(v) for v in value]
    return value


_HELPERS = {
    "call_name": (ast.Call,), "attr_chain": (ast.Attribute, ast.Name),
    "static_len": (ast.List, ast.Tuple, ast.BinOp, ast.Call),
    "static_elements": (ast.List, ast.Tuple, ast.BinOp, ast.Call),
    "literal_strings": (ast.Set, ast.List, ast.Tuple, ast.Call, ast.BinOp),
}


@pytest.mark.parametrize("helper", sorted(_HELPERS))
def test_astutil_helpers_match_the_reference(helper):
    """Each helper on every node of its kinds in the fixtures and the
    reference's own lint modules gives the reference's result."""
    paths = _fixture_sources() + sorted(glob.glob(
        os.path.join(REPO, "apex_tpu", "lint", "*.py")))
    n = 0
    for p in paths:
        for node in ast.walk(ast.parse(open(p).read())):
            if isinstance(node, _HELPERS[helper]):
                n += 1
                assert _norm(getattr(astutil, helper)(node)) == \
                    _norm(getattr(ref_astutil, helper)(node))
    assert n > 50


@pytest.mark.parametrize("helper", ["walk_scope", "functions_in"])
def test_scope_helpers_match_the_reference(helper):
    for p in _fixture_sources():
        tree = ast.parse(open(p).read())
        for node in [tree] + astutil.functions_in(tree):
            got = getattr(astutil, helper)(node)
            want = getattr(ref_astutil, helper)(node)
            assert [ast.dump(n) for n in got] == \
                [ast.dump(n) for n in want]


def test_kwarg_matches_the_reference():
    tree = ast.parse("f(a, axis_name='data', dtype=x.float32)")
    call = tree.body[0].value
    for name in ("axis_name", "dtype", "missing"):
        assert _norm(astutil.kwarg(call, name)) == \
            _norm(ref_astutil.kwarg(call, name))


def test_import_origins_and_dotted():
    tree = ast.parse(
        "import torch\nimport torch.distributed as dist\n"
        "from torch.utils.checkpoint import checkpoint as ck\n"
        "import numpy.random\nfrom . import local\n")
    origins = astutil.import_origins(tree)
    assert origins == {"torch": "torch", "dist": "torch.distributed",
                       "ck": "torch.utils.checkpoint.checkpoint",
                       "numpy": "numpy"}
    expr = ast.parse("dist.all_reduce", mode="eval").body
    assert astutil.dotted(expr, origins) == "torch.distributed.all_reduce"
    assert astutil.dotted(ast.parse("re.compile", mode="eval").body,
                          origins) is None


@pytest.mark.parametrize("flag,item", [("trace_registry", "A8.3"),
                                       ("cost_registry", "A8.3"),
                                       ("sharding_registry", "A8.4"),
                                       ("scaling_registry", "A8.5")])
def test_unported_tiers_raise_naming_their_item(flag, item):
    with pytest.raises(NotImplementedError, match=item):
        engine.lint_paths([FIXTURES], **{flag: True})


def test_trace_default_runs_the_ported_checks_either_way():
    """``trace`` has no pass of its own until A8.2: both values give the
    same findings."""
    path = [os.path.join(FIXTURES, "apx106_bad.py")]
    on, _ = engine.lint_paths(path)
    off, _ = engine.lint_paths(path, trace=False)
    assert on == off and {f.code for f in on} == {"APX106"}


def test_unparsable_file_is_apx100(tmp_path):
    p = tmp_path / "broken.py"
    p.write_text("def f(:\n")
    findings, n = engine.lint_paths([str(p)])
    assert n == 0 and [f.code for f in findings] == ["APX100"]


def test_suppression_comments_silence_what_fires(tmp_path):
    """The torch fixtures' suppressions silence real findings: with the
    comments taken out, the same files fire."""
    for name, code in (("suppressed.py", "APX401"),
                       ("suppressed_file.py", "APX402")):
        src = open(os.path.join(FIXTURES, name)).read()
        assert engine.lint_paths([os.path.join(FIXTURES, name)])[0] == []
        bare = tmp_path / name
        bare.write_text(re.sub(r"#\s*apxlint: disable.*", "", src))
        codes = {f.code for f in engine.lint_paths([str(bare)])[0]}
        assert code in codes


# -- the CLI ----------------------------------------------------------------

def test_cli_exit_codes(capsys):
    bad = os.path.join(FIXTURES, "apx106_bad.py")
    clean = os.path.join(FIXTURES, "apx106_clean.py")
    assert main(["--include-fixtures", bad]) == 1
    assert "APX106" in capsys.readouterr().out
    assert main(["--include-fixtures", clean]) == 0
    assert main(["--select", "APX999", clean]) == 2
    assert main(["--codes", "APX87*", clean]) == 2
    assert "matches no known code" in capsys.readouterr().err
    assert main(["--codes", "APX5*", clean]) == 2
    assert "not ported yet (ROADMAP A8.3)" in capsys.readouterr().err
    with pytest.raises(SystemExit) as e:   # no flag for an unported tier
        main(["--trace", clean])
    assert e.value.code == 2


def test_cli_select_and_codes(capsys):
    bad = os.path.join(FIXTURES, "apx201_bad.py")
    assert main(["--include-fixtures", "--select", "APX202", bad]) == 0
    assert main(["--include-fixtures", "--codes", "APX20*", bad]) == 1
    out = capsys.readouterr().out
    assert "APX201" in out and "APX106" not in out


def test_cli_list_codes_prints_both_kinds(capsys):
    assert main(["--list-codes"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == len(CODES)
    assert any(l.startswith("APX801  ") and "not yet" not in l
               for l in lines)
    assert any(l.startswith("APX511  not yet ported (A8.3)") for l in lines)


def test_cli_defaults_to_apex_tpu_torch(tmp_path, monkeypatch, capsys):
    """With no path the CLI lints ``apex_tpu_torch`` under the working
    directory."""
    pkg = tmp_path / "apex_tpu_torch"
    pkg.mkdir()
    src = open(os.path.join(FIXTURES, "apx402_bad.py")).read()
    (pkg / "blocks.py").write_text(src.replace("# apxlint: fixture\n", ""))
    monkeypatch.chdir(tmp_path)
    assert main([]) == 1
    assert "APX402" in capsys.readouterr().out


# -- the port itself --------------------------------------------------------

def test_port_lints_clean():
    """The tentpole's run, as a user types it: ``python -m
    apex_tpu_torch.lint apex_tpu_torch tests/test_torch_*.py
    chip_smoke.py --determinism`` exits 0 over more than 200 files."""
    tests = sorted(glob.glob(os.path.join("tests", "test_torch_*.py")))
    proc = subprocess.run(
        [sys.executable, "-m", "apex_tpu_torch.lint", "apex_tpu_torch",
         *tests, "chip_smoke.py", "--determinism"], cwd=REPO,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    n = int(re.search(r"clean, (\d+) file", proc.stdout).group(1))
    assert n > 200


def test_lint_imports_neither_torch_nor_jax():
    """The lint reads source with ``ast``: its modules import the
    standard library and ``apex_tpu_torch.lint`` only."""
    lint = os.path.join(REPO, "apex_tpu_torch", "lint")
    stdlib = {"argparse", "ast", "dataclasses", "fnmatch", "os", "re",
              "sys", "tokenize", "typing"}
    for dirpath, _, files in os.walk(lint):
        for f in files:
            if not f.endswith(".py"):
                continue
            tree = ast.parse(open(os.path.join(dirpath, f)).read())
            for node in ast.walk(tree):
                if isinstance(node, ast.Import):
                    mods = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and not node.level:
                    mods = [node.module]
                else:
                    continue
                for m in mods:
                    assert m in stdlib or m.startswith(
                        "apex_tpu_torch.lint"), (f, m)


def test_named_idioms_are_clean_without_suppression():
    """The cases the JAX rules misread are clean because the port's rules
    read the idiom: the fp32-operand products of ``quant/kernels.py``,
    the ``_fault(site)`` helper, ``_key_grid``'s folded seed key; and no
    port module carries a suppression for them."""
    port = os.path.join(REPO, "apex_tpu_torch")
    for rel in ("quant/kernels.py", "serving/scheduler.py"):
        src = open(os.path.join(port, rel)).read()
        assert "apxlint: disable" not in src
    kern = open(os.path.join(port, "quant", "kernels.py")).read()
    lines = kern.splitlines()
    assert "torch.matmul(x2.float(), _dequant(" in lines[73]
    assert "torch.matmul(x2.abs(), w.abs())" in lines[267]
    sched = open(os.path.join(port, "serving", "scheduler.py")).read()
    assert 'self._fault("chunk_prefill_exec")' in sched
    assert "base = prng.PRNGKey(" in sched
    findings, _ = engine.lint_paths(
        [os.path.join(port, "quant"), os.path.join(port, "serving")],
        determinism=True)
    assert findings == []

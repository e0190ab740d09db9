"""The port's APX8xx determinism tier (``apex_tpu_torch.lint.
determinism``) over ``apex_tpu_torch/serving``: every code fires on its
known-bad fixture and stays silent on its known-clean twin, and — the
load-bearing part — on its bug class seeded into a scratch copy of the
REAL port serving package (with the port's tests and the repo's CI
matrix beside it, so APX802/803 see their cross-artifacts):

- APX801: the chunked-prefill progress loop and the preemption requeue
  iterating a set;
- APX802: the scheduler's ``_fault`` helper no longer consulting its
  site (``chunk_prefill_exec`` is consulted only through it), a
  ``host_promote`` consultation removed, and a CI matrix leg dropped;
- APX803: an untyped ``RuntimeError`` raised on the tick path;
- APX804: a span name outside ``observe.PHASES``;
- APX805: a raw key in ``scheduler._slot_key``.

Serving-scoped fixtures are copied into a ``serving`` directory under
``tmp_path`` (the tier scopes any directory named ``serving``; none is
committed under ``tests/``). The APX802/803 mini-repos are the JAX
package's fixtures translated to the port's layout (``apex_tpu_torch/
serving``, tests that import ``apex_tpu_torch``): the port's rules count
only the tests of the package, so the untranslated fixtures would name
every site and class, by design."""

import os
import shutil

import pytest

from apex_tpu.lint.engine import lint_paths as ref_lint_paths
from apex_tpu_torch.lint.__main__ import main
from apex_tpu_torch.lint.engine import lint_paths

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SERVING = os.path.join(REPO, "apex_tpu_torch", "serving")
TICK = os.path.join(REPO, "tests", "torch_lint_fixtures", "tick")
REF_DET = os.path.join(REPO, "tests", "L0", "run_lint", "fixtures",
                       "determinism")

#: fixture -> the (code, line) findings it must give in a serving dir
BAD = {
    "apx801_bad.py": [("APX801", 11), ("APX801", 12), ("APX801", 13),
                      ("APX801", 14)],
    "apx803_bad.py": [("APX803", 9)],
    "apx805_bad.py": [("APX805", 9), ("APX805", 11), ("APX805", 12)],
}
CLEAN = ("apx801_clean.py", "apx803_clean.py", "apx805_clean.py")


def _lint(paths, **kw):
    kw.setdefault("determinism", True)
    findings, _ = lint_paths([str(p) for p in paths], **kw)
    return findings


def _in_serving(tmp_path, name):
    dst = tmp_path / "serving"
    dst.mkdir(exist_ok=True)
    shutil.copy(os.path.join(TICK, name), dst / name)
    return dst / name


@pytest.mark.parametrize("name", sorted(BAD))
def test_bad_fixture_fires(tmp_path, name):
    path = _in_serving(tmp_path, name)
    assert [(f.code, f.line) for f in _lint([path])] == BAD[name]
    # outside a serving directory the tier does not look
    assert _lint([os.path.join(TICK, name)], include_fixtures=True) == []


@pytest.mark.parametrize("name", CLEAN)
def test_clean_fixture_is_silent(tmp_path, name):
    assert _lint([_in_serving(tmp_path, name)]) == []


def test_apx801_torch_draws_need_a_generator(tmp_path):
    msgs = [f.message for f in _lint([_in_serving(tmp_path,
                                                  "apx801_bad.py")])]
    assert "torch.rand" in msgs[0] and "generator=" in msgs[0]
    assert "probs.uniform_" in msgs[1]
    assert "probs.multinomial" in msgs[2]
    assert "iteration over a set" in msgs[3]


def test_apx805_folded_seed_key_is_not_consumed(tmp_path):
    """``base = prng.PRNGKey(s)`` folded at every offset is clean; the
    same name also handed to a consumer is a raw key."""
    src = tmp_path / "serving"
    src.mkdir()
    (src / "grid.py").write_text(
        "from apex_tpu_torch.utils import prng\n\n\n"
        "class Sched:\n"
        "    def step(self, seed, offs, logits):\n"
        "        base = prng.PRNGKey(seed)\n"
        "        keys = [prng.fold_in(base, o) for o in offs]\n"
        "        return self.sample(logits, keys)\n")
    assert _lint([src]) == []
    (src / "grid.py").write_text(
        (src / "grid.py").read_text().replace(
            "self.sample(logits, keys)", "self.sample(logits, base)"))
    assert [(f.code, f.line) for f in _lint([src])] == [("APX805", 6)]


# ---------------------------------------------------------------------------
# APX802 / APX803 mini-repos: the JAX package's fixtures, translated
# ---------------------------------------------------------------------------

def _translated(tmp_path, name):
    """The reference mini-repo ``name`` with ``apex_tpu/`` renamed
    ``apex_tpu_torch/`` and every test importing the port first."""
    dst = tmp_path / name
    shutil.copytree(os.path.join(REF_DET, name), dst)
    if (dst / "apex_tpu").exists():
        (dst / "apex_tpu").rename(dst / "apex_tpu_torch")
    for t in (dst / "tests").glob("*.py"):
        lines = t.read_text().splitlines(keepends=True)
        t.write_text(lines[0] + "import apex_tpu_torch\n"
                     + "".join(lines[1:]))
    return dst


def _rel(findings, root):
    return [(f.code, os.path.relpath(f.path, root).replace(
        "apex_tpu_torch", "apex_tpu"), f.line) for f in findings]


@pytest.mark.parametrize("name", ["apx802_bad", "apx802_clean",
                                  "apx803_cov_bad", "apx803_cov_clean"])
def test_translated_mini_repos_give_the_references_findings(tmp_path,
                                                            name):
    dst = _translated(tmp_path, name)
    ref, _ = ref_lint_paths([os.path.join(REF_DET, name)], trace=False,
                            determinism=True, include_fixtures=True)
    got = _lint([dst], include_fixtures=True)
    # the import line moved each test's lines by one: only serving-side
    # findings are compared line for line
    assert _rel(got, dst) == _rel(ref, os.path.join(REF_DET, name))
    assert bool(got) == name.endswith("_bad")


def test_a_jax_test_does_not_vouch_for_the_port(tmp_path):
    """The clean mini-repo with its test no longer importing the port:
    the sites lose their chaos reference and sweep reader, the taxonomy
    class its test (APX802, APX803)."""
    for name, code in (("apx802_clean", "APX802"),
                       ("apx803_cov_clean", "APX803")):
        dst = _translated(tmp_path, name)
        assert _lint([dst], include_fixtures=True) == []
        jax_side = tmp_path / f"{name}_jax"   # a new root: no cached text
        shutil.copytree(dst, jax_side)
        for t in (jax_side / "tests").glob("*.py"):
            t.write_text(t.read_text().replace("import apex_tpu_torch\n",
                                               "import apex_tpu\n"))
        got = {f.code for f in _lint([jax_side], include_fixtures=True)}
        assert got == {code}


def test_apx802_helper_consultation_counts(tmp_path):
    """A site consulted only through a helper whose parameter reaches
    ``.fire`` (``self._fault("alpha_exec")``) has its consultation; a
    helper that stops consulting leaves it with none."""
    dst = _translated(tmp_path, "apx802_clean")
    faults = dst / "apex_tpu_torch" / "serving" / "faults.py"
    src = faults.read_text()
    assert 'self.injector.draw("alpha_exec")' in src
    faults.write_text(src.replace(
        'self.injector.draw("alpha_exec")', 'self._fault("alpha_exec")')
        + "\n    def _fault(self, site):\n"
          "        if self.injector.fire(site):\n"
          "            raise ValueError(site)\n")
    assert _lint([dst], include_fixtures=True) == []
    faults.write_text(faults.read_text().replace(
        "if self.injector.fire(site):", "if site is None:"))
    got = _lint([dst], include_fixtures=True)
    assert [f.code for f in got] == ["APX802"]
    assert "'alpha_exec' has no consultation" in got[0].message


# ---------------------------------------------------------------------------
# seeded bugs in a scratch copy of the real serving package
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def scratch_base(tmp_path_factory):
    """``apex_tpu_torch/serving``, the port's tests and the CI matrix, as
    they stand, in a scratch repo; lints clean."""
    root = tmp_path_factory.mktemp("repo")
    shutil.copytree(SERVING, root / "apex_tpu_torch" / "serving",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (root / "tests").mkdir()
    for f in sorted(os.listdir(os.path.join(REPO, "tests"))):
        if f.startswith("test_torch_") and f.endswith(".py"):
            shutil.copy(os.path.join(REPO, "tests", f), root / "tests" / f)
    (root / ".github" / "workflows").mkdir(parents=True)
    shutil.copy(os.path.join(REPO, ".github", "workflows", "ci.yml"),
                root / ".github" / "workflows" / "ci.yml")
    assert _lint([root / "apex_tpu_torch" / "serving"]) == []
    return root


@pytest.fixture
def scratch(scratch_base, tmp_path):
    dst = tmp_path / "repo"
    shutil.copytree(scratch_base, dst)
    return dst


def _mutate(path, old, new):
    src = path.read_text()
    assert src.count(old) == 1, f"mutation anchor drifted: {old!r}"
    path.write_text(src.replace(old, new))
    return src[:src.index(old)].count("\n") + 1


def _seeded(scratch, rel, old, new, code):
    path = scratch / "apex_tpu_torch" / "serving" / rel
    line = _mutate(path, old, new)
    findings = _lint([scratch / "apex_tpu_torch" / "serving"],
                     select=(code,))
    assert findings, f"{code} missed the seeded bug"
    return line, findings


def test_seeded_unsorted_progress_loop(scratch):
    line, f = _seeded(scratch, "scheduler.py",
                      "for rid in sorted(progressed):",
                      "for rid in progressed:", "APX801")
    assert [(x.line, os.path.basename(x.path)) for x in f] == [
        (line, "scheduler.py")]
    assert "iteration over a set" in f[0].message


def test_seeded_unsorted_requeue(scratch):
    """The preemption requeue over a set: the requeue order (and so the
    resume order of preempted requests) becomes hash-dependent."""
    line, f = _seeded(
        scratch, "scheduler.py",
        "for i in sorted(preempted, key=lambda j: self._slots[j]."
        "request_id,\n                        reverse=True):",
        "for i in set(preempted):", "APX801")
    assert [x.line for x in f] == [line]
    assert "'_prepare'" in f[0].message


def test_seeded_helper_stops_consulting(scratch):
    """``chunk_prefill_exec`` is consulted only through ``_fault``: with
    the helper no longer drawing, the site has no consultation."""
    _, f = _seeded(scratch, "scheduler.py",
                   "        if self.injector.fire(site):\n"
                   "            raise InjectedFault(site, "
                   "self.injector.calls(site) - 1)",
                   "        if site is None:\n"
                   "            raise InjectedFault(site, 0)", "APX802")
    assert len(f) == 1
    assert "'chunk_prefill_exec' has no consultation" in f[0].message


def test_seeded_consultation_removed(scratch):
    _, f = _seeded(scratch, "scheduler.py",
                   'self.injector.fire("host_promote")', "False",
                   "APX802")
    assert len(f) == 1 and "'host_promote'" in f[0].message


def test_seeded_dropped_ci_matrix_leg(scratch):
    """Drop ``APEX_CHAOS_POOL_SEED`` from the scratch CI matrix: the
    reshard and pool-route sites lose their sweep."""
    ci = scratch / ".github" / "workflows" / "ci.yml"
    src = ci.read_text()
    ci.write_text("\n".join(l for l in src.splitlines()
                            if "APEX_CHAOS_POOL_SEED" not in l))
    findings = _lint([scratch / "apex_tpu_torch" / "serving"],
                     select=("APX802",))
    rendered = "\n".join(f.render() for f in findings)
    for site in ("reshard_send", "reshard_recv", "pool_route"):
        assert site in rendered, rendered


def test_seeded_untyped_raise_on_the_tick(scratch):
    line, f = _seeded(scratch, "scheduler.py",
                      "        self._expire_deadlines()\n"
                      "        self._admit()\n",
                      "        self._expire_deadlines()\n"
                      "        if self._tick_no < 0:\n"
                      "            raise RuntimeError(\"tick clock ran "
                      "backwards\")\n"
                      "        self._admit()\n", "APX803")
    assert [x.line for x in f] == [line + 2]
    assert "untyped RuntimeError" in f[0].message


def test_seeded_span_outside_phases(scratch):
    line, f = _seeded(scratch, "scheduler.py",
                      'trc.begin("prepare_decode")',
                      'trc.begin("prepare_decod")', "APX804")
    assert [x.line for x in f] == [line]
    assert "PHASES" in f[0].message


def test_seeded_raw_key_in_slot_key(scratch):
    line, f = _seeded(scratch, "scheduler.py",
                      "    return prng.fold_in(prng.PRNGKey(slot.request."
                      "seed),\n                        len(slot.generated))",
                      "    return prng.PRNGKey(slot.request.seed)", "APX805")
    assert [x.line for x in f] == [line]
    assert "'_slot_key'" in f[0].message


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def test_cli_codes_apx8_glob_enables_the_tier(tmp_path, capsys):
    bad = _in_serving(tmp_path, "apx805_bad.py")
    assert main(["--codes", "APX8*", str(bad)]) == 1
    assert "APX805" in capsys.readouterr().out
    assert main([str(bad)]) == 0          # without the tier: no APX8xx
    assert main(["--determinism", str(bad)]) == 1
    clean = _in_serving(tmp_path, "apx805_clean.py")
    assert main(["--determinism", str(clean)]) == 0

"""apxlint driver for the port: file walking, suppression comments,
check dispatch.

The engine owns everything that is not a check: collecting ``.py``
files, parsing them once, reading ``# apxlint: disable=CODE`` comments
(flagged line, or a standalone comment line directly above it) and
``# apxlint: disable-file=CODE`` headers, and skipping ``# apxlint:
fixture`` files during directory walks so the known-bad test fixtures
don't fail a repo-wide run while still being lintable when passed as
explicit paths. The comment syntax is the JAX package's, so one
suppression reads the same to both checkers.

Checks come in two shapes:

- per-file AST checks (``quant``, ``collectives``) get
  ``(tree, path)`` and return findings;
- project checks run once over the whole file set: ``amp_lists`` (the
  op-list module and every ``cast_args`` site together), ``hygiene``
  (roots a CUDA-graph capture, ``torch.compile`` / ``torch.jit`` or an
  activation checkpoint across module boundaries, so
  ``checkpoint(imported_fn, ...)`` in one file taints the defining
  file), and, with ``determinism=True`` (CLI ``--determinism``), the
  APX8xx tier over the serving-scope files (any ``serving/`` directory
  in the linted set): tick-path ordering, fault-contract coverage,
  taxonomy closure, observe coherence and RNG key discipline.

The JAX package's Pallas- and jaxpr-bound tiers have no port yet
(:data:`apex_tpu_torch.lint.PENDING`): ``trace_registry``,
``cost_registry``, ``sharding_registry`` and ``scaling_registry`` raise
``NotImplementedError`` naming their ROADMAP item. ``trace`` (default
True) selects the VMEM budget pass (APX102) in the JAX package; the
port's kernels are CUDA with no VMEM, and their shared-memory budgets
come with A8.2, so until then ``trace`` runs no pass of its own: every
ported AST check runs with either value.
"""

import ast
import os
import re
import tokenize
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from apex_tpu_torch.lint import CODES, Finding

_SUPPRESS_RE = re.compile(r"#\s*apxlint:\s*disable=([A-Z0-9,\s]+)")
_SUPPRESS_FILE_RE = re.compile(
    r"#\s*apxlint:\s*disable-file=([A-Z0-9,\s]+)")
_FIXTURE_RE = re.compile(r"#\s*apxlint:\s*fixture")
_SKIP_DIRS = {"__pycache__", ".git", ".jax_cache", ".pytest_cache",
              "build", "dist"}

#: engine flag -> (ROADMAP item, tier) of the tiers not ported yet
_UNPORTED = {
    "trace_registry": ("A8.3", "the jaxpr trace tier (APX5xx)"),
    "cost_registry": ("A8.3", "the cost tier (APX6xx)"),
    "sharding_registry": ("A8.4", "the sharding tier (APX7xx)"),
    "scaling_registry": ("A8.5", "the scaling tier (APX9xx)"),
}


def collect_files(paths: Sequence[str],
                  include_fixtures: bool = False) -> List[str]:
    """Expand files/directories into a sorted list of lintable .py files."""
    out: Set[str] = set()
    for p in paths:
        if os.path.isfile(p):
            out.add(os.path.abspath(p))  # explicit paths always lint
            continue
        for root, dirs, files in os.walk(p):
            dirs[:] = [d for d in dirs if d not in _SKIP_DIRS]
            for f in files:
                if not f.endswith(".py"):
                    continue
                fp = os.path.abspath(os.path.join(root, f))
                if not include_fixtures and is_fixture_file(fp):
                    continue
                out.add(fp)
    return sorted(out)


def is_fixture_file(path: str) -> bool:
    try:
        with open(path, "r", encoding="utf-8") as fh:
            head = "".join(fh.readline() for _ in range(3))
    except OSError:
        return False
    return bool(_FIXTURE_RE.search(head))


def parse_suppressions(src: str) -> Dict[int, Set[str]]:
    """Map line number -> suppressed codes on that line.

    An inline comment suppresses its own line; a standalone comment line
    suppresses itself and the following line, so multi-code disables can
    sit above long statements.
    """
    sup: Dict[int, Set[str]] = {}
    for i, line in enumerate(src.splitlines(), start=1):
        m = _SUPPRESS_RE.search(line)
        if not m:
            continue
        codes = {c.strip() for c in m.group(1).split(",") if c.strip()}
        sup.setdefault(i, set()).update(codes)
        if line.lstrip().startswith("#"):  # standalone comment line
            sup.setdefault(i + 1, set()).update(codes)
    return sup


def parse_file_suppressions(src: str) -> Set[str]:
    """Codes suppressed for the whole file: ``# apxlint:
    disable-file=CODE[,CODE...]`` on any comment-only line
    (conventionally the module header)."""
    out: Set[str] = set()
    for line in src.splitlines():
        if not line.lstrip().startswith("#"):
            continue
        m = _SUPPRESS_FILE_RE.search(line)
        if m:
            out.update(c.strip() for c in m.group(1).split(",")
                       if c.strip())
    return out


def _read(path: str) -> Optional[str]:
    try:
        with tokenize.open(path) as fh:  # honors PEP 263 encodings
            return fh.read()
    except (OSError, SyntaxError, UnicodeDecodeError):
        return None


def lint_paths(paths: Sequence[str], *, include_fixtures: bool = False,
               trace: bool = True, trace_registry: bool = False,
               cost_registry: bool = False,
               sharding_registry: bool = False,
               scaling_registry: bool = False,
               determinism: bool = False,
               cost_report_out: Optional[list] = None,
               scaling_timings_out: Optional[list] = None,
               select: Optional[Iterable[str]] = None
               ) -> Tuple[List[Finding], int]:
    """Run all ported checks over ``paths``; returns (findings,
    files_checked). ``trace`` has no pass of its own yet (module doc);
    ``cost_report_out`` and ``scaling_timings_out`` stay untouched, as
    their tiers are not ported."""
    asked = {"trace_registry": trace_registry,
             "cost_registry": cost_registry,
             "sharding_registry": sharding_registry,
             "scaling_registry": scaling_registry}
    for flag, on in asked.items():
        if on:
            item, tier = _UNPORTED[flag]
            raise NotImplementedError(
                f"{flag}=True: {tier} is not ported yet (ROADMAP {item})")

    from apex_tpu_torch.lint import amp_lists, collectives, hygiene, quant

    files = collect_files(paths, include_fixtures=include_fixtures)
    findings: List[Finding] = []
    sources: Dict[str, str] = {}
    trees: Dict[str, ast.Module] = {}

    for path in files:
        src = _read(path)
        if src is None:
            continue
        try:
            tree = ast.parse(src, filename=path)
        except SyntaxError as e:
            findings.append(Finding(
                "APX100", path, e.lineno or 1,
                f"file does not parse: {e.msg}"))
            continue
        sources[path] = src
        trees[path] = tree
        for checker in (quant, collectives):
            findings.extend(checker.check_module(tree, path))

    findings.extend(hygiene.check_files(trees))
    findings.extend(amp_lists.check_files(trees))
    if determinism:
        from apex_tpu_torch.lint import determinism as det
        findings.extend(det.check_files(trees))

    findings = _apply_suppressions(findings, sources)
    if select is not None:
        keep = tuple(select)
        findings = [f for f in findings if f.code.startswith(keep)]
    findings.sort(key=lambda f: (f.path, f.line, f.code))
    return findings, len(trees)


def _apply_suppressions(findings: List[Finding],
                        sources: Dict[str, str]) -> List[Finding]:
    by_file: Dict[str, Dict[int, Set[str]]] = {}
    file_wide: Dict[str, Set[str]] = {}
    out = []
    for f in findings:
        if f.code not in CODES:
            raise ValueError(f"checker emitted unregistered code {f.code}")
        if f.path not in by_file:
            src = sources.get(f.path)
            if src is None:  # a path outside the linted set
                src = _read(f.path) or ""
            by_file[f.path] = parse_suppressions(src)
            file_wide[f.path] = parse_file_suppressions(src)
        if f.code in file_wide[f.path]:
            continue
        if f.code in by_file[f.path].get(f.line, ()):
            continue
        out.append(f)
    return out

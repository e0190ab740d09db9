"""APX802 — fault-contract coverage for ``faults.SITES``.

A fault site is a five-artifact contract, and history says the
artifacts drift apart: a new site needs (a) a hook-consultation call
in the serving code, (b) a typed degrade path, (c) a chaos test that
actually schedules it, and (d) — for the swept families — a seed env
in the CI chaos matrix, or the site ships with a fault nobody can
inject and a recovery ladder nobody has run. Conversely a site
removed from ``SITES`` leaves stale names in tests and CI that keep
passing while testing nothing. This check makes the contract a single
declared table and cross-verifies every edge:

``faults.SITE_CONTRACTS`` maps every site to
``(error_class_or_None, sweep_env_or_None)`` — the typed error its
degrade path raises (``None`` for policy-only faults that alter a
decision instead of raising, e.g. ``pool_route`` falling back to
fixed-order routing), and the CI chaos-matrix env var that sweeps its
seed (``None`` for sites exercised by the default deterministic
schedules in the chaos tests rather than a matrix leg).

Per scope containing a ``faults.py`` that declares ``SITES``:

- ``SITE_CONTRACTS`` exists and its keys equal ``SITES`` exactly;
- every site has a consultation call site: a string literal argument
  to ``.draw(...)`` / ``.fire(...)`` / ``.calls(...)``, or a
  ``*_site = "..."`` class attribute (the transfer channels'
  indirection) somewhere in the scope;
- a declared error class resolves to a class defined or imported in
  the scope;
- every site is referenced by name in a test file that mentions
  ``chaos`` (the deterministic-replay suites);
- a declared sweep env appears in ``.github/workflows/ci.yml`` AND in
  at least one test (the test must read the env for the matrix leg to
  vary anything);
- reverse direction: every ``APEX_CHAOS_*SEED`` env in ci.yml is a
  declared sweep of some site and is read by some test — a matrix
  leg sweeping an env nobody reads is coverage theater.

Scopes without a ``faults.py``/``SITES`` (fixture mini-repos for the
other codes) are skipped silently.

Two departures from the JAX package's rule, both for the port's idiom
and its place in a shared repo:

- **Helper consultation.** The port's scheduler consults some sites
  through a helper, ``self._fault("chunk_prefill_exec")``, whose
  parameter reaches ``self.injector.fire(site)``. A serving-scope
  function whose parameter is passed (as the first argument) to
  ``.draw`` / ``.fire`` / ``.calls``, or on to another such helper, is a
  consulting helper, and a string literal passed at that parameter's
  position (or by its name) is a consultation site.
- **The package's tests.** "Referenced by a chaos test" and "read by a
  test" count only the tests that import the package holding the
  serving scope (:func:`~.repofiles.package_tests`): the JAX package's
  chaos suites sit in the same ``tests/`` and read the same ``ci.yml``
  variables, and their mentions must not vouch for the port.
"""

import ast
import re
from typing import Dict, List, Optional, Set, Tuple

from apex_tpu_torch.lint import Finding
from apex_tpu_torch.lint.astutil import call_name
from apex_tpu_torch.lint.determinism import repofiles
from apex_tpu_torch.lint.determinism.reach import serving_dir

_SWEEP_RE = re.compile(r"APEX_CHAOS_[A-Z_]*SEED")
_CONSULTERS = ("draw", "fire", "calls")


def _module_assign(tree: ast.Module, name: str) -> Optional[ast.Assign]:
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and node.targets[0].id == name:
            return node
    return None


def _sites(node: ast.Assign) -> Optional[List[str]]:
    if not isinstance(node.value, (ast.Tuple, ast.List)):
        return None
    out = []
    for e in node.value.elts:
        if not (isinstance(e, ast.Constant) and isinstance(e.value, str)):
            return None
        out.append(e.value)
    return out


def _contracts(node: ast.Assign) -> Optional[
        Dict[str, Tuple[Optional[str], Optional[str], int]]]:
    """site -> (error, sweep, lineno); None if not a literal dict of
    2-tuples."""
    if not isinstance(node.value, ast.Dict):
        return None
    out: Dict[str, Tuple[Optional[str], Optional[str], int]] = {}
    for k, v in zip(node.value.keys, node.value.values):
        if not (isinstance(k, ast.Constant) and isinstance(k.value, str)
                and isinstance(v, ast.Tuple) and len(v.elts) == 2
                and all(isinstance(e, ast.Constant)
                        and (e.value is None or isinstance(e.value, str))
                        for e in v.elts)):
            return None
        out[k.value] = (v.elts[0].value, v.elts[1].value, k.lineno)
    return out


def _site_arg(call: ast.Call, pos: int, param: str) -> Optional[ast.AST]:
    if len(call.args) > pos:
        return call.args[pos]
    return next((kw.value for kw in call.keywords if kw.arg == param), None)


def _helpers(trees: Dict[str, ast.Module]) -> Dict[str, Tuple[int, str]]:
    """name -> (position, parameter) of the serving-scope functions whose
    parameter reaches a ``.draw`` / ``.fire`` / ``.calls`` call, directly
    or through another such helper (a fixpoint); the position skips a
    leading ``self`` / ``cls``."""
    fns = [n for t in trees.values() for n in ast.walk(t)
           if isinstance(n, ast.FunctionDef)]
    found: Dict[str, Tuple[int, str]] = {
        c: (0, "site") for c in _CONSULTERS}
    grew = True
    while grew:
        grew = False
        for fn in fns:
            if fn.name in found:
                continue
            params = [a.arg for a in fn.args.posonlyargs + fn.args.args]
            if params and params[0] in ("self", "cls"):
                params = params[1:]
            for node in ast.walk(fn):
                if not (isinstance(node, ast.Call)
                        and call_name(node) in found):
                    continue
                pos, name = found[call_name(node)]
                arg = _site_arg(node, pos, name)
                if isinstance(arg, ast.Name) and arg.id in params:
                    found[fn.name] = (params.index(arg.id), arg.id)
                    grew = True
                    break
    return found


def _consulted(trees: Dict[str, ast.Module]) -> Set[str]:
    out: Set[str] = set()
    helpers = _helpers(trees)
    for tree in trees.values():
        for node in ast.walk(tree):
            if isinstance(node, ast.Call) and call_name(node) in helpers:
                arg = _site_arg(node, *helpers[call_name(node)])
                if isinstance(arg, ast.Constant) \
                        and isinstance(arg.value, str):
                    out.add(arg.value)
            elif isinstance(node, ast.Assign) \
                    and isinstance(node.value, ast.Constant) \
                    and isinstance(node.value.value, str):
                for t in node.targets:
                    if isinstance(t, ast.Name) \
                            and t.id.endswith("_site"):
                        out.add(node.value.value)
    return out


def _known_classes(trees: Dict[str, ast.Module]) -> Set[str]:
    out: Set[str] = set()
    for tree in trees.values():
        for node in ast.walk(tree):
            if isinstance(node, ast.ClassDef):
                out.add(node.name)
            elif isinstance(node, ast.ImportFrom):
                out.update(a.asname or a.name for a in node.names)
    return out


def check_files(strees: Dict[str, ast.Module]) -> List[Finding]:
    findings: List[Finding] = []

    scopes: Dict[str, Dict[str, ast.Module]] = {}
    for path, tree in strees.items():
        scopes.setdefault(serving_dir(path), {})[path] = tree

    for scope in sorted(scopes):
        trees = scopes[scope]
        fpath = next((p for p in trees
                      if p.rsplit("/", 1)[-1] == "faults.py"), None)
        if fpath is None:
            continue
        ftree = trees[fpath]
        sites_node = _module_assign(ftree, "SITES")
        sites = _sites(sites_node) if sites_node is not None else None
        if sites is None:
            continue  # not a fault-registry module

        def emit(line: int, msg: str) -> None:
            findings.append(Finding("APX802", fpath, line, msg))

        contracts_node = _module_assign(ftree, "SITE_CONTRACTS")
        contracts = _contracts(contracts_node) \
            if contracts_node is not None else None
        if contracts is None:
            emit(sites_node.lineno,
                 "SITES has no literal SITE_CONTRACTS table mapping "
                 "every site to (typed error | None, sweep env | "
                 "None) — the fault contract must be declared to be "
                 "checkable")
            continue

        for name in sites:
            if name not in contracts:
                emit(contracts_node.lineno,
                     f"site '{name}' is in SITES but missing from "
                     "SITE_CONTRACTS")
        for name, (_, _, line) in contracts.items():
            if name not in sites:
                emit(line, f"SITE_CONTRACTS names '{name}' which is "
                           "not in SITES (stale entry)")

        consulted = _consulted(trees)
        known = _known_classes(trees)
        root = repofiles.repo_root(scope)
        texts = repofiles.package_tests(scope)
        ci = repofiles.ci_text(root)
        chaos_blob = "" if texts is None else "\n".join(
            t for t in texts.values() if "chaos" in t)
        test_blob = "" if texts is None else "\n".join(texts.values())

        if texts is None:
            emit(sites_node.lineno,
                 "fault sites are declared but the tree has no "
                 "tests/ directory — every site needs a chaos-test "
                 "reference")
        declared_sweeps: Set[str] = set()
        for name in sites:
            err, sweep, line = contracts.get(name, (None, None,
                                                    sites_node.lineno))
            if name not in consulted:
                emit(line, f"site '{name}' has no consultation call "
                           "site (.draw/.fire/.calls literal or "
                           "*_site attribute) anywhere in the "
                           "serving scope — a fault nobody can "
                           "inject")
            if err is not None and err not in known:
                emit(line, f"site '{name}' declares degrade error "
                           f"'{err}' which is neither defined nor "
                           "imported in the serving scope")
            if texts is not None and not re.search(
                    rf"[\"']{re.escape(name)}[\"']", chaos_blob):
                emit(line, f"site '{name}' is referenced by no chaos "
                           "test of the package under tests/ — its "
                           "schedule has never replayed")
            if sweep is not None:
                declared_sweeps.add(sweep)
                if ci is not None and sweep not in ci:
                    emit(line, f"site '{name}' declares sweep env "
                               f"{sweep} which is absent from the CI "
                               "chaos matrix (ci.yml)")
                if texts is not None and sweep not in test_blob:
                    emit(line, f"site '{name}' declares sweep env "
                               f"{sweep} which no test of the package "
                               "reads — the matrix leg would vary "
                               "nothing")
        if ci is None:
            if declared_sweeps:
                emit(sites_node.lineno,
                     "SITE_CONTRACTS declares CI sweep envs but the "
                     "tree has no .github/workflows/ci.yml")
        else:
            for env in sorted(set(_SWEEP_RE.findall(ci))):
                if env not in declared_sweeps:
                    emit(sites_node.lineno,
                         f"CI chaos matrix fans {env} which no "
                         "SITE_CONTRACTS entry declares (stale "
                         "matrix leg)")
                elif texts is not None and env not in test_blob:
                    emit(sites_node.lineno,
                         f"CI chaos matrix fans {env} which no test "
                         "of the package reads — coverage theater")
    return findings

"""APX803 — error-taxonomy closure on the tick path.

The serving stack's failure handling is typed end-to-end: the
scheduler's degrade ladders (quarantine → retry → requeue → finish),
the router's failover picks, and the chaos tests' assertions all
dispatch on ``ServingError`` subclasses from ``serving.health``. An
untyped ``raise RuntimeError(...)`` on the tick path silently falls
through every one of those ladders — the stream dies wholesale
instead of degrading, and no chaos leg ever exercises the path
because nothing catches it to assert on. Two directions:

**Raise closure.** Every ``raise Cls(...)`` in a tick-reachable
function must name either a taxonomy class (a ClassDef in the serving
scope whose base chain reaches ``ServingError``, or ``InjectedFault``
— the fault hook's own typed carrier), a name imported from a serving
``health`` / ``faults`` module, or an allowlisted constructor-time
guard (``ValueError`` / ``TypeError`` / ``NotImplementedError`` /
``StopIteration`` — argument validation that fires on the caller's
stack before any stream state exists). Re-raises (``raise`` /
``raise err`` / ``raise self``) are flow, not new error types, and
never flag.

**Test coverage.** Every taxonomy class must appear by name in at
least one file under ``tests/`` — an error class no test references
is a degrade path that has never executed, which in this codebase
means its determinism contract is unverified. Checked only when the
serving scope declares the taxonomy (a ``health.py`` with
``ServingError``); fixture mini-repos without one skip it. As in APX802,
only the tests that import the package holding the serving scope count
(:func:`~.repofiles.package_tests`): the JAX package's tests name the
same classes and vouch for its own.

The port's ``RuntimeError`` guards sit in its kernel wrappers (a CUDA
tensor goes to the kernel or raises), outside ``serving/``; the one
``raise RuntimeError`` in ``serving/`` is ``PageReshard.__init__``'s
guard, a constructor the tick does not reach, so the JAX package's
allowlist stays as it is.
"""

import ast
import re
from typing import Dict, List, Set

from apex_tpu_torch.lint import Finding
from apex_tpu_torch.lint.astutil import call_name
from apex_tpu_torch.lint.determinism import repofiles
from apex_tpu_torch.lint.determinism.reach import (reachable_functions,
                                                   serving_dir)

#: Builtin exceptions a tick-reachable function may raise directly:
#: constructor/argument-time guards that fire before any stream state
#: exists. Everything else on the tick path must be typed.
RAISE_ALLOWLIST = frozenset({
    "ValueError", "TypeError", "NotImplementedError", "StopIteration",
})


def _taxonomy_classes(trees: Dict[str, ast.Module]
                      ) -> Dict[str, "ast.ClassDef"]:
    """name -> ClassDef for every class in the scope whose base chain
    reaches ServingError (plus InjectedFault, the injector's typed
    carrier)."""
    defs: Dict[str, ast.ClassDef] = {}
    bases: Dict[str, Set[str]] = {}
    for tree in trees.values():
        for node in ast.walk(tree):
            if isinstance(node, ast.ClassDef):
                defs[node.name] = node
                bases[node.name] = {
                    b.id for b in node.bases if isinstance(b, ast.Name)
                } | {b.attr for b in node.bases
                     if isinstance(b, ast.Attribute)}

    out: Dict[str, ast.ClassDef] = {}
    for name in defs:
        seen: Set[str] = set()
        frontier = [name]
        while frontier:
            cur = frontier.pop()
            if cur in seen:
                continue
            seen.add(cur)
            if cur in ("ServingError", "InjectedFault"):
                out[name] = defs[name]
                break
            frontier.extend(bases.get(cur, ()))
    return out


def _serving_imports(trees: Dict[str, ast.Module]) -> Set[str]:
    """Names imported from a serving health/faults module anywhere in
    the scope — typed by construction even if the defining module is
    outside the linted file set."""
    out: Set[str] = set()
    for tree in trees.values():
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom) and node.module:
                tail = node.module.rsplit(".", 1)[-1]
                if tail in ("health", "faults", "serving"):
                    out.update(a.asname or a.name for a in node.names)
    return out


def check_files(strees: Dict[str, ast.Module]) -> List[Finding]:
    findings: List[Finding] = []

    scopes: Dict[str, Dict[str, ast.Module]] = {}
    for path, tree in strees.items():
        scopes.setdefault(serving_dir(path), {})[path] = tree

    for scope in sorted(scopes):
        trees = scopes[scope]
        taxonomy = _taxonomy_classes(trees)
        typed = set(taxonomy) | {"ServingError", "InjectedFault"} \
            | _serving_imports(trees) | RAISE_ALLOWLIST

        # -- raise closure over tick-reachable functions --------------
        for path, fn in reachable_functions(trees):
            for node in ast.walk(fn):
                if not isinstance(node, ast.Raise) or node.exc is None:
                    continue
                if not isinstance(node.exc, ast.Call):
                    continue  # `raise err` / `raise self`: a re-raise
                name = call_name(node.exc)
                if name is None or name in typed:
                    continue
                findings.append(Finding(
                    "APX803", path, node.lineno,
                    f"'{fn.name}' raises untyped {name} on the tick "
                    "path — degrade ladders dispatch on ServingError "
                    "subclasses; raise a taxonomy class (or move "
                    "pure argument validation off the tick path)"))

        # -- taxonomy test coverage -----------------------------------
        declares = any(
            isinstance(n, ast.ClassDef) and n.name == "ServingError"
            for t in trees.values() for n in ast.walk(t))
        if not declares:
            continue
        texts = repofiles.package_tests(scope)
        if texts is None:
            findings.append(Finding(
                "APX803", sorted(trees)[0], 1,
                "serving scope declares an error taxonomy but the "
                "tree has no tests/ directory — every taxonomy class "
                "needs at least one test reference"))
            continue
        blob = "\n".join(texts.values())
        for name in sorted(taxonomy):
            if re.search(rf"\b{re.escape(name)}\b", blob):
                continue
            node = taxonomy[name]
            cpath = next(p for p, t in trees.items()
                         if node in ast.walk(t))
            findings.append(Finding(
                "APX803", cpath, node.lineno,
                f"taxonomy class {name} appears in no test of the "
                "package under tests/ — its degrade path has never "
                "executed, so "
                "its determinism contract is unverified"))
    return findings

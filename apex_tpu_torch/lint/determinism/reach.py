"""Tick-path reachability for the determinism tier (APX8xx), as in the
JAX package: the port's scheduler and router carry the same five roots
(``run``, ``step``, ``submit``, ``health_tick``,
``begin_admission_pass``), so the closure reads them unchanged.

The APX8xx checks care about one execution surface: the serving
engine's deterministic tick loop — everything that runs between a
``submit()`` and a committed token, because that is the code whose
ordering decisions flow into commit order and must replay bit-for-bit
under a pinned fault schedule (the chaos contract every serving PR
asserts dynamically). Host-side code OUTSIDE that surface — replica
validation in a constructor, a ``__repr__``, an export helper — is free
to iterate sets or read ``id()``; flagging it would be noise.

So, exactly like ``hygiene.py`` builds the set of functions reachable
from a *trace* root, this module builds the set of functions reachable
from the *tick/admission* roots:

- :data:`TICK_ROOTS` — ``run`` / ``step`` / ``submit`` (the
  ``ContinuousBatchingScheduler`` public drain surface) plus the
  router's per-tick admission hooks (``health_tick``,
  ``begin_admission_pass``). Every scheduler phase (``_tick``,
  ``_admit``, ``_decode_phase``, ``_prefill_phase``, ...), every
  engine wrapper (``prefill`` / ``chunk_prefill`` / ``decode`` /
  ``verify`` / ``tree_verify`` / ``draft*`` / ``sample`` /
  ``commit``), and every transfer/reshard/spill/promote path hangs off
  these by direct call.
- Closure is by *terminal identifier*, cross-module over the serving
  scope: ``self.engine.chunk_prefill(...)`` reaches every serving
  function named ``chunk_prefill`` regardless of which module defines
  it. This over-approximates (a shared method name anywhere in
  ``serving/`` joins the tick path) — deliberate: a reachability MISS
  would silently exempt a scheduling decision from APX801, while an
  over-approximation merely asks for a ``sorted()`` or a suppression
  comment in code that could plausibly be called from a tick.

Scope selection is by path: a file participates in the serving scope
when it sits in a directory named ``serving`` (the real package, a
fixture mini-repo, or a scratch copy under test — the seeded-bug
meta-tests copy ``scheduler.py`` into ``<tmp>/serving/`` and relint).
``tests/L0/run_serving`` does NOT match: the component is
``run_serving``, not ``serving``.
"""

import ast
import os
from typing import Dict, Iterable, List, Set, Tuple

#: The tick/admission roots: the public drain surface of the scheduler
#: plus the router hooks it invokes once per tick. Everything the
#: determinism tier scopes to is reachable from these by name.
TICK_ROOTS = frozenset({
    "run", "step", "submit", "health_tick", "begin_admission_pass",
})


def serving_trees(trees: Dict[str, ast.Module]) -> Dict[str, ast.Module]:
    """The subset of the linted file set that lives in a ``serving``
    directory — the only files the APX8xx checks look at."""
    out = {}
    for path, tree in trees.items():
        parts = os.path.normpath(path).split(os.sep)
        if "serving" in parts[:-1]:
            out[path] = tree
    return out


def serving_dir(path: str) -> str:
    """The ``.../serving`` directory that puts ``path`` in scope."""
    parts = os.path.normpath(path).split(os.sep)
    idx = len(parts) - 1 - parts[-2::-1].index("serving")
    return os.sep.join(parts[:idx])


class FnInfo:
    """One serving-scope function: its AST, its file, and the terminal
    identifiers it mentions (call targets, attribute tails, bare
    names) — the edges of the reachability graph."""

    __slots__ = ("path", "node", "mentions")

    def __init__(self, path: str, node: ast.FunctionDef):
        self.path = path
        self.node = node
        self.mentions = _mentions(node)


def _mentions(fn: ast.FunctionDef) -> Set[str]:
    out: Set[str] = set()
    for n in ast.walk(fn):
        if isinstance(n, ast.Call):
            f = n.func
            if isinstance(f, ast.Attribute):
                out.add(f.attr)
            elif isinstance(f, ast.Name):
                out.add(f.id)
        elif isinstance(n, ast.Attribute):
            out.add(n.attr)
        elif isinstance(n, ast.Name):
            out.add(n.id)
    return out


def _function_defs(tree: ast.Module) -> List[ast.FunctionDef]:
    return [n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef)]


def reachable_functions(strees: Dict[str, ast.Module],
                        roots: Iterable[str] = TICK_ROOTS
                        ) -> List[Tuple[str, ast.FunctionDef]]:
    """All (path, FunctionDef) pairs reachable from the tick roots by
    cross-module terminal-name closure over the serving scope."""
    by_name: Dict[str, List[FnInfo]] = {}
    for path in sorted(strees):
        for fn in _function_defs(strees[path]):
            by_name.setdefault(fn.name, []).append(FnInfo(path, fn))

    seen: Set[int] = set()
    out: List[Tuple[str, ast.FunctionDef]] = []
    frontier = [n for n in roots if n in by_name]
    while frontier:
        name = frontier.pop()
        for info in by_name.get(name, ()):
            if id(info.node) in seen:
                continue
            seen.add(id(info.node))
            out.append((info.path, info.node))
            frontier.extend(m for m in info.mentions if m in by_name)
    return out

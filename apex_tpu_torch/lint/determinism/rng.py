"""APX805 — RNG key discipline on the tick path, in the port's idiom.

Sampling randomness in the serving engine must be a pure function of
``(request seed, position counter)`` — that is what makes a committed
stream replayable across restarts, failovers, and replica migrations:
the decode slot that picks up a preempted stream re-derives the exact
key the original slot would have used. The repo's idiom is

    key = jax.random.fold_in(jax.random.PRNGKey(req.seed), step)

and batched variants that ``jnp.stack`` per-slot keys. Two statically
detectable ways to break it:

**Raw PRNGKey on the tick path.** A ``PRNGKey(...)`` whose result is
consumed directly (not folded, not an element of a batched key stack)
gives every step of the stream the SAME key — identical draws at
every position, and no counter to re-derive after a migration. A
``PRNGKey`` call is fine when (a) some enclosing call in the same
expression is ``fold_in`` (it is the seed root of a fold chain), or
(b) it is an element of a list/tuple/comprehension that feeds a
``stack`` / ``concatenate`` / ``array`` / ``asarray`` call (the
batched-slot idiom — the fold already happened upstream or the slot
is inert/padding).

**Key reuse.** A local name bound to a ``fold_in`` / ``PRNGKey``
result and then passed as an argument to two or more distinct calls:
the second consumer sees correlated randomness. Deriving is not
consuming — passing the key to ``fold_in`` / ``split`` again is how
chains are built and does not count as a use.

``split`` is also flagged on the tick path when it is clearly a key
split (an attribute chain mentioning ``random`` or ``prng`` —
``jax.random.split``, the port's ``prng.split`` — or a name imported
from a module ending in ``random`` or ``prng``): split trees make the
key at a position depend on how many OTHER streams were scheduled that
tick, which is exactly the cross-request coupling fold_in chains avoid.
(``s.split(",")`` on strings has neither in its chain and is never
flagged.)

The port's keys are ``utils.prng``'s threefry keys, bit for bit
jax.random's, and its idiom is ``prng.fold_in(prng.PRNGKey(seed),
n)``. It also names the seed key once and folds it many times
(``base = prng.PRNGKey(seed)`` then ``prng.fold_in(base, o)`` for each
offset, ``scheduler._key_grid``): deriving is not consuming, so a
``PRNGKey`` bound to a local name is blessed when every use of that
name in the function is as the key argument of ``fold_in``.
"""

import ast
from typing import Dict, List, Set

from apex_tpu_torch.lint import Finding
from apex_tpu_torch.lint.astutil import attr_chain, call_name
from apex_tpu_torch.lint.determinism.reach import reachable_functions

_STACKERS = {"stack", "concatenate", "array", "asarray"}


def _parents(fn: ast.FunctionDef) -> Dict[int, ast.AST]:
    out: Dict[int, ast.AST] = {}
    for node in ast.walk(fn):
        for child in ast.iter_child_nodes(node):
            out[id(child)] = node
    return out


def _random_split_names(tree: ast.Module) -> Set[str]:
    """Local names that are a key ``split`` via from-import."""
    out: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module \
                and node.module.endswith(("random", "prng")):
            for a in node.names:
                if a.name == "split":
                    out.add(a.asname or "split")
    return out


def _key_ok(call: ast.Call, parents: Dict[int, ast.AST]) -> bool:
    """Is this PRNGKey(...) call blessed — under a fold_in, or an
    element of a batched key stack?"""
    node: ast.AST = call
    while id(node) in parents:
        parent = parents[id(node)]
        if isinstance(parent, ast.Call):
            pn = call_name(parent)
            if pn == "fold_in":
                return True
            if pn in _STACKERS:
                return True
        if isinstance(parent, (ast.stmt,)) and not isinstance(
                parent, ast.Expr):
            # climbed out of the expression without meeting a blesser
            # — except keep climbing through simple value statements
            # so `key = fold_in(PRNGKey(s), 0)` (Assign) still works:
            # the Call check above already fired before we got here.
            return False
        node = parent
    return False


def _folded_only(fn: ast.FunctionDef, parents: Dict[int, ast.AST]
                 ) -> Set[int]:
    """ids of the ``PRNGKey(...)`` calls bound by a single-name
    assignment whose name, everywhere in the function, is only the key
    argument of ``fold_in``."""
    loads: Dict[str, List[ast.Name]] = {}
    bound: Dict[str, List[ast.Call]] = {}
    for node in ast.walk(fn):
        if isinstance(node, ast.Name):
            if isinstance(node.ctx, ast.Load):
                loads.setdefault(node.id, []).append(node)
            continue
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            if isinstance(node.value, ast.Call) \
                    and call_name(node.value) == "PRNGKey":
                bound.setdefault(node.targets[0].id, []).append(
                    node.value)
            else:
                bound.setdefault(node.targets[0].id, []).append(None)
    out: Set[int] = set()
    for name, calls in bound.items():
        uses = loads.get(name, [])
        if None in calls or not uses:
            continue
        if all(isinstance(parents.get(id(u)), ast.Call)
               and call_name(parents[id(u)]) == "fold_in"
               and parents[id(u)].args and parents[id(u)].args[0] is u
               for u in uses):
            out.update(id(c) for c in calls)
    return out


def check_files(strees: Dict[str, ast.Module]) -> List[Finding]:
    findings: List[Finding] = []
    reach: Dict[str, List[ast.FunctionDef]] = {}
    for path, fn in reachable_functions(strees):
        reach.setdefault(path, []).append(fn)

    for path in sorted(reach):
        split_imports = _random_split_names(strees[path])
        for fn in reach[path]:
            parents = _parents(fn)
            folded = _folded_only(fn, parents)
            # name -> line where bound to a key-producing call
            key_names: Dict[str, int] = {}
            for node in ast.walk(fn):
                if isinstance(node, ast.Assign) and isinstance(
                        node.value, ast.Call) and call_name(
                        node.value) in ("fold_in", "PRNGKey"):
                    for t in node.targets:
                        if isinstance(t, ast.Name):
                            key_names[t.id] = node.lineno

            uses: Dict[str, List[int]] = {}
            for node in ast.walk(fn):
                if not isinstance(node, ast.Call):
                    continue
                cn = call_name(node)
                if cn == "PRNGKey" and id(node) not in folded \
                        and not _key_ok(node, parents):
                    findings.append(Finding(
                        "APX805", path, node.lineno,
                        f"raw PRNGKey on the tick path in '{fn.name}' "
                        "— a fixed key repeats the same draw at every "
                        "position; derive per-step keys as "
                        "fold_in(PRNGKey(request seed), counter)"))
                elif cn == "split":
                    chain = attr_chain(node.func)
                    is_random = (chain is not None and bool(
                        {"random", "prng"} & set(chain[:-1]))) or (
                        isinstance(node.func, ast.Name)
                        and node.func.id in split_imports)
                    if is_random:
                        findings.append(Finding(
                            "APX805", path, node.lineno,
                            f"key split in '{fn.name}' on the "
                            "tick path — split trees couple a "
                            "stream's key to what else was scheduled "
                            "that tick; use fold_in(seed, counter) "
                            "chains"))
                # key reuse: a bound key passed as an argument to
                # distinct consumer calls (fold_in/split derive, they
                # don't consume)
                if cn in ("fold_in", "split"):
                    continue
                for arg in list(node.args) + [kw.value for kw in
                                              node.keywords]:
                    if isinstance(arg, ast.Name) and arg.id in key_names:
                        uses.setdefault(arg.id, []).append(node.lineno)
            for name, lines in sorted(uses.items()):
                if len(lines) > 1:
                    findings.append(Finding(
                        "APX805", path, lines[1],
                        f"key '{name}' (bound at line "
                        f"{key_names[name]}) consumed by "
                        f"{len(lines)} calls in '{fn.name}' — reusing "
                        "a key correlates draws; fold_in a fresh "
                        "counter per consumer"))
    return findings

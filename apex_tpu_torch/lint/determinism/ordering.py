"""APX801 — nondeterministic ordering on the tick path.

The serving contract is that committed streams are bit-identical to
golden through every scheduling, speculation, handoff, failover, and
fault path. Every dynamic test of that contract assumes the host-side
scheduler makes the SAME decisions in the SAME order on every replay —
which a single ``for x in some_set:`` can silently break: CPython set
iteration order depends on insertion history and element hashes, and
str hashes are salted per process (PYTHONHASHSEED), so an order that
happens to be stable today ships a replay divergence the first time a
key type changes. This is exactly the bug class of the PR-8 unsorted
preemption requeue. The check is a small taint walk:

**Set-order taint.** An expression is set-typed when it is a ``set()``
/ ``frozenset()`` call, a set literal/comprehension, set algebra over a
set-typed operand (``| & - ^``, ``.union`` and friends), a local name
assigned one of those, or an attribute the module assigns one to
(``self._parked = set()``). Flagged consumers — the points where the
arbitrary order MATERIALIZES into scheduling, requeue, routing, or
commit order — inside tick-reachable functions
(:mod:`~apex_tpu.lint.determinism.reach`):

- ``for x in S:`` and comprehension sources (list/dict/generator —
  a SET comprehension over a set stays unordered and is fine);
- order-materializing calls: ``list(S)``, ``tuple(S)``,
  ``enumerate(S)``, ``iter(S)``, ``map(f, S)``, ``zip(.., S, ..)``,
  ``S.pop()``, ``sep.join(S)``;
- unpacking ``a, b = S``.

``sorted(S)`` / ``min`` / ``max`` / ``len`` / ``sum`` / ``any`` /
``all`` / membership consume a set without consuming its *order* and
never flag.

**Nondeterministic text.** A set interpolated into a string (f-string,
``str(S)``, ``format(S)``, ``repr(S)``, ``"%s" % S``) prints in
arbitrary order — an error message that names the same defect two
different ways on two runs breaks log diffing and golden-text tests.
Error text is usually raised OFF the tick path (constructor
validation), so this sub-check runs over every function in the serving
scope, reachable or not.

**Nondeterministic primitives**, tick-reachable functions only:
``hash(x)`` / ``id(x)`` (process-dependent values used as ordering or
routing keys — also flagged anywhere as a ``key=`` of
``sorted``/``min``/``max``), unseeded stdlib ``random.*`` and
``np.random.*`` calls, torch draws from the process's global stream (a
``torch.rand`` / ``rand_like`` / ``randn`` / ``randn_like`` /
``randint`` / ``randperm`` / ``multinomial`` / ``bernoulli`` /
``normal`` / ``poisson`` call, or an in-place ``random_`` /
``normal_`` / ``uniform_`` / ``bernoulli_`` / ``exponential_`` /
``geometric_`` / ``cauchy_`` / ``log_normal_`` or a ``multinomial`` /
``bernoulli`` tensor method, with no ``generator=``: the port's
sampling keys go through ``utils.prng`` and a seeded generator, never
the global stream), and wall-clock reads (``time.*``,
``perf_counter``) — the tick clock is the only clock scheduling may
consult. The one legitimate wall-clock surface is the Tracer's
dual-stamp sites in ``observe.py`` (``instant``/``begin``/``end``
stamp wall time for Perfetto, excluded from the replay contract by
``TraceEvent.tick_key``); those three methods are the explicit
allowlist (:data:`WALL_CLOCK_ALLOWLIST`).
"""

import ast
from typing import Dict, List, Set, Tuple

from apex_tpu_torch.lint import Finding
from apex_tpu_torch.lint.astutil import attr_chain, call_name
from apex_tpu_torch.lint.determinism.reach import reachable_functions

#: (file basename, function name) pairs allowed to read the wall
#: clock: the Tracer's event-stamp sites, whose wall fields are
#: excluded from the deterministic tick stream by design.
WALL_CLOCK_ALLOWLIST = frozenset({
    ("observe.py", "instant"),
    ("observe.py", "begin"),
    ("observe.py", "end"),
})

_SET_METHODS = {"union", "difference", "intersection",
                "symmetric_difference", "copy"}
_ORDER_SINKS = {"list", "tuple", "enumerate", "iter", "map", "zip"}
_TEXT_SINKS = {"str", "format", "repr"}
_TORCH_DRAWS = {"rand", "rand_like", "randn", "randn_like", "randint",
                "randint_like", "randperm", "multinomial", "bernoulli",
                "normal", "poisson"}
_TENSOR_DRAWS = {"random_", "normal_", "uniform_", "bernoulli_",
                 "exponential_", "geometric_", "cauchy_", "log_normal_",
                 "multinomial", "bernoulli"}


def _attr_set_names(tree: ast.Module) -> Set[str]:
    """Attribute tails the module binds to a set anywhere
    (``self._parked = set()`` / ``x.pending: set = ...``)."""
    out: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign):
            targets, value, ann = node.targets, node.value, None
        elif isinstance(node, ast.AnnAssign):
            targets, value, ann = [node.target], node.value, node.annotation
        else:
            continue
        is_set = (value is not None and _is_set_expr(value, set(), set())) \
            or (ann is not None and isinstance(ann, ast.Name)
                and ann.id in ("set", "frozenset")) \
            or (ann is not None and isinstance(ann, ast.Subscript)
                and isinstance(ann.value, ast.Name)
                and ann.value.id in ("Set", "FrozenSet"))
        if not is_set:
            continue
        for t in targets:
            if isinstance(t, ast.Attribute):
                out.add(t.attr)
    return out


def _is_set_expr(node: ast.AST, names: Set[str],
                 attrs: Set[str]) -> bool:
    if isinstance(node, (ast.Set, ast.SetComp)):
        return True
    if isinstance(node, ast.Call):
        cn = call_name(node)
        if cn in ("set", "frozenset"):
            return True
        if cn in _SET_METHODS and isinstance(node.func, ast.Attribute):
            return _is_set_expr(node.func.value, names, attrs)
        return False
    if isinstance(node, ast.Name):
        return node.id in names
    if isinstance(node, ast.Attribute):
        return node.attr in attrs
    if isinstance(node, ast.BinOp) and isinstance(
            node.op, (ast.BitOr, ast.BitAnd, ast.Sub, ast.BitXor)):
        return (_is_set_expr(node.left, names, attrs)
                or _is_set_expr(node.right, names, attrs))
    if isinstance(node, ast.IfExp):
        return (_is_set_expr(node.body, names, attrs)
                and _is_set_expr(node.orelse, names, attrs))
    return False


def _local_set_names(fn: ast.FunctionDef, attrs: Set[str]) -> Set[str]:
    """Fixpoint over the function's assignments: local names that hold
    a set at some point. One name, one taint — a name rebound to a
    list later stays tainted (conservative, but a finding there still
    reads correctly: don't reuse the name)."""
    names: Set[str] = set()
    for _ in range(4):
        grew = False
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign):
                targets, value = node.targets, node.value
            elif isinstance(node, ast.AnnAssign) and node.value is not None:
                targets, value = [node.target], node.value
            elif isinstance(node, ast.AugAssign) and isinstance(
                    node.op, (ast.BitOr, ast.BitAnd, ast.Sub, ast.BitXor)):
                targets, value = [node.target], node.value
            else:
                continue
            if not _is_set_expr(value, names, attrs) and not (
                    isinstance(node, ast.AugAssign)
                    and isinstance(node.target, ast.Name)
                    and node.target.id in names):
                continue
            for t in targets:
                if isinstance(t, ast.Name) and t.id not in names:
                    names.add(t.id)
                    grew = True
        if not grew:
            break
    return names


def _host_modules(tree: ast.Module) -> Dict[str, str]:
    """Local alias -> module for time / random / numpy / torch imports,
    plus names imported from ``time`` directly (``perf_counter``)."""
    out: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                root = a.name.split(".")[0]
                if root in ("time", "random", "numpy", "torch"):
                    out[a.asname or root] = root
        elif isinstance(node, ast.ImportFrom) and node.module:
            root = node.module.split(".")[0]
            if root == "time":
                for a in node.names:
                    out[a.asname or a.name] = "time"
            elif root == "numpy" and any(a.name == "random"
                                         for a in node.names):
                for a in node.names:
                    if a.name == "random":
                        out[a.asname or "random"] = "numpy.random"
    return out


def _global_torch_draw(node: ast.Call, host: Dict[str, str]) -> bool:
    """A torch random draw with no ``generator=`` (module doc)."""
    if not isinstance(node.func, ast.Attribute) or any(
            kw.arg == "generator" for kw in node.keywords):
        return False
    chain = attr_chain(node.func)
    if chain and len(chain) == 2 and host.get(chain[0]) == "torch":
        return chain[1] in _TORCH_DRAWS
    return node.func.attr in _TENSOR_DRAWS and not (
        chain and chain[0] in host)


def check_files(strees: Dict[str, ast.Module]) -> List[Finding]:
    findings: List[Finding] = []
    reach: Dict[str, List[ast.FunctionDef]] = {}
    for path, fn in reachable_functions(strees):
        reach.setdefault(path, []).append(fn)

    for path in sorted(strees):
        tree = strees[path]
        attrs = _attr_set_names(tree)
        host = _host_modules(tree)
        reachable = {id(fn) for fn in reach.get(path, ())}
        all_fns = [n for n in ast.walk(tree)
                   if isinstance(n, ast.FunctionDef)]
        seen: Set[Tuple[int, str]] = set()

        def emit(line: int, tag: str, msg: str) -> None:
            if (line, tag) not in seen:
                seen.add((line, tag))
                findings.append(Finding("APX801", path, line, msg))

        for fn in all_fns:
            names = _local_set_names(fn, attrs)
            on_tick = id(fn) in reachable

            def set_typed(node: ast.AST) -> bool:
                return _is_set_expr(node, names, attrs)

            for node in ast.walk(fn):
                # --- text sinks: every function in serving scope ----
                if isinstance(node, ast.FormattedValue) \
                        and set_typed(node.value):
                    emit(node.value.lineno, "text",
                         f"set interpolated into a string in "
                         f"'{fn.name}' prints in arbitrary order — "
                         "wrap it in sorted() so the text is "
                         "deterministic")
                    continue
                if isinstance(node, ast.BinOp) \
                        and isinstance(node.op, ast.Mod) \
                        and isinstance(node.left, ast.Constant) \
                        and isinstance(node.left.value, str):
                    rhs = (node.right.elts
                           if isinstance(node.right, ast.Tuple)
                           else [node.right])
                    if any(set_typed(r) for r in rhs):
                        emit(node.lineno, "text",
                             f"set formatted into a string in "
                             f"'{fn.name}' prints in arbitrary order "
                             "— wrap it in sorted()")
                    continue
                if isinstance(node, ast.Call):
                    cn = call_name(node)
                    if cn in _TEXT_SINKS and node.args \
                            and set_typed(node.args[0]):
                        emit(node.lineno, "text",
                             f"{cn}() of a set in '{fn.name}' renders "
                             "in arbitrary order — sorted() first")
                        continue
                    if cn == "join" and isinstance(node.func,
                                                  ast.Attribute) \
                            and node.args and set_typed(node.args[0]):
                        emit(node.lineno, "order",
                             f"str.join over a set in '{fn.name}' "
                             "concatenates in arbitrary order — "
                             "sorted() first")
                        continue
                    # hash/id as an ordering key, anywhere
                    if cn in ("sorted", "min", "max"):
                        for kw in node.keywords:
                            if kw.arg == "key" and isinstance(
                                    kw.value, ast.Name) \
                                    and kw.value.id in ("hash", "id"):
                                emit(node.lineno, "hash",
                                     f"{kw.value.id}() as a {cn} key "
                                     f"in '{fn.name}' orders by a "
                                     "process-dependent value")

                # --- tick-path-only rules ---------------------------
                if not on_tick:
                    continue
                if isinstance(node, ast.For) and set_typed(node.iter):
                    emit(node.iter.lineno, "iter",
                         f"iteration over a set in '{fn.name}' on the "
                         "tick path — the visit order flows into "
                         "scheduling/requeue/commit order; iterate "
                         "sorted(...) instead")
                elif isinstance(node, (ast.ListComp, ast.DictComp,
                                       ast.GeneratorExp)):
                    for gen in node.generators:
                        if set_typed(gen.iter):
                            emit(gen.iter.lineno, "iter",
                                 f"comprehension over a set in "
                                 f"'{fn.name}' on the tick path "
                                 "materializes an arbitrary order — "
                                 "iterate sorted(...) instead")
                elif isinstance(node, ast.Assign) and len(
                        node.targets) == 1 and isinstance(
                        node.targets[0], ast.Tuple) \
                        and set_typed(node.value):
                    emit(node.lineno, "iter",
                         f"unpacking a set in '{fn.name}' on the tick "
                         "path binds in arbitrary order")
                elif isinstance(node, ast.Call):
                    cn = call_name(node)
                    if cn in _ORDER_SINKS and node.args and any(
                            set_typed(a) for a in node.args):
                        emit(node.lineno, "order",
                             f"{cn}() over a set in '{fn.name}' on "
                             "the tick path materializes an "
                             "arbitrary order — sorted() instead")
                    elif cn == "pop" and isinstance(node.func,
                                                    ast.Attribute) \
                            and not node.args \
                            and set_typed(node.func.value):
                        emit(node.lineno, "order",
                             f"set.pop() in '{fn.name}' on the tick "
                             "path removes an arbitrary element")
                    elif cn in ("hash", "id") and isinstance(
                            node.func, ast.Name):
                        emit(node.lineno, "hash",
                             f"{cn}() in '{fn.name}' on the tick path "
                             "— process-dependent values must not "
                             "feed scheduling or routing keys")
                    elif _global_torch_draw(node, host):
                        emit(node.lineno, "random",
                             f"torch draw '{ast.unparse(node.func)}' "
                             f"with no generator= in '{fn.name}' on the "
                             "tick path — it takes the process's global "
                             "stream; pass a seeded generator or derive "
                             "the bits from the request seed via "
                             "fold_in (APX805)")
                    elif cn is not None and isinstance(node.func,
                                                       ast.Attribute):
                        chain = attr_chain(node.func)
                        if chain and chain[0] in host:
                            root = host[chain[0]]
                            base = path.rsplit("/", 1)[-1]
                            if root == "time" and (
                                    base, fn.name
                            ) not in WALL_CLOCK_ALLOWLIST:
                                emit(node.lineno, "clock",
                                     f"wall-clock read "
                                     f"'{'.'.join(chain)}' in "
                                     f"'{fn.name}' on the tick path — "
                                     "the tick clock is the only "
                                     "clock scheduling may consult "
                                     "(Tracer wall stamps in "
                                     "observe.py are the allowlisted "
                                     "exception)")
                            elif root in ("random", "numpy.random") or (
                                    root == "numpy" and len(chain) > 2
                                    and chain[1] == "random"):
                                emit(node.lineno, "random",
                                     f"unseeded RNG "
                                     f"'{'.'.join(chain)}' in "
                                     f"'{fn.name}' on the tick path — "
                                     "derive randomness from the "
                                     "request seed via fold_in "
                                     "(APX805) or the FaultInjector "
                                     "hash draw")
                    elif cn is not None and isinstance(node.func,
                                                       ast.Name) \
                            and node.func.id in host \
                            and host[node.func.id] == "time":
                        base = path.rsplit("/", 1)[-1]
                        if (base, fn.name) not in WALL_CLOCK_ALLOWLIST:
                            emit(node.lineno, "clock",
                                 f"wall-clock read '{node.func.id}()' "
                                 f"in '{fn.name}' on the tick path — "
                                 "use the deterministic tick clock")
    return findings

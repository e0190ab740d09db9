"""Capture-and-replay hygiene checks (APX401, APX402), re-read for
PyTorch.

The JAX package's hazard is a traced body: it runs once at trace time,
so host state it reads is baked into the compiled program. Eager
PyTorch runs Python on every call, so ``torch.autograd.Function``
``forward``/``backward`` bodies are NOT roots here (the ``global
staged_bytes`` counter that ``mappings.collective`` bumps under
``_Shift.forward`` is a counter, not a fault). The hazard exists in
eager PyTorch only where Python runs a different number of times than
the work it describes:

- **CUDA-graph capture.** The body of ``with torch.cuda.graph(g):``,
  the statements between ``g.capture_begin()`` and ``g.capture_end()``,
  and the callables handed to ``torch.cuda.make_graphed_callables``:
  Python runs once, and every replay repeats the captured values.
- **Compilation.** Functions decorated with, or passed to,
  ``torch.compile``, ``torch.jit.script`` or ``torch.jit.trace``:
  the compiled program keeps what the trace saw.
- **Activation checkpointing.** Functions passed to
  ``torch.utils.checkpoint.checkpoint`` / ``checkpoint_sequential`` or
  the port's ``tensor_parallel.random.checkpoint``: the recompute runs
  them a second time, so a host read there gives the backward another
  value than the forward had, and a global write happens twice.

Roots resolve through the module's imports (``torch.compile`` and not
``re.compile``; ``checkpoint`` imported from ``torch.utils.checkpoint``
or the port's ``tensor_parallel``), and through ``functools.partial``.
Reachability closes transitively over module-local function names, and
across modules through ``from apex_tpu_torch.x import name``: a root
made of an imported function taints the file that defines it.

Host reads are the JAX package's: ``time``, ``random``,
``numpy.random`` and ``datetime.now/today/utcnow`` (matched against the
module's imports), and the port's registered serving host state —
``serving.faults``, ``health``, ``observe``, ``transfer``, ``router``,
``tenancy`` and ``streaming``, their stateful classes, and module-level
instances of them. APX402 flags a ``global`` statement in the same
reachable set.
"""

import ast
import os
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from apex_tpu_torch.lint import Finding
from apex_tpu_torch.lint.astutil import (
    attr_chain,
    call_name,
    dotted,
    import_origins,
    walk_scope,
)

_PKG = "apex_tpu_torch"

#: dotted callables whose function arguments are roots
_ROOT_CALLS = {
    "torch.compile", "torch.jit.script", "torch.jit.trace",
    "torch.utils.checkpoint.checkpoint",
    "torch.utils.checkpoint.checkpoint_sequential",
    "torch.cuda.make_graphed_callables",
    f"{_PKG}.transformer.tensor_parallel.random.checkpoint",
    f"{_PKG}.transformer.tensor_parallel.checkpoint",
}
#: dotted decorators that make the decorated function a root
_ROOT_DECORATORS = {"torch.compile", "torch.jit.script"}
_GRAPH_CONTEXTS = {"torch.cuda.graph"}

#: port modules whose contents are host state by design: their
#: counters/schedules mutate between scheduler ticks
_HOST_STATE_MODULES = {f"{_PKG}.serving.{m}" for m in (
    "faults", "health", "observe", "transfer", "router", "tenancy",
    "streaming")}
#: the stateful classes those modules export (re-exported by
#: ``apex_tpu_torch.serving``)
_HOST_STATE_SYMBOLS = {"FaultInjector", "ServingStats", "Tracer",
                       "MetricsRegistry", "FlightRecorder",
                       "PageTransfer", "ReplicaHealth",
                       "DisaggregatedRouter", "TenancyPolicy",
                       "StreamMux"}


def _host_modules(tree: ast.Module) -> Dict[str, str]:
    """Local alias -> canonical host-module name, from this module's
    imports only."""
    out: Dict[str, str] = {}
    interesting = {"time", "random", "numpy", "datetime"}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                root = a.name.split(".")[0]
                if root in interesting:
                    out[a.asname or root] = root
        elif isinstance(node, ast.ImportFrom):
            if node.module and node.module.split(".")[0] == "numpy":
                for a in node.names:
                    if a.name == "random":
                        out[a.asname or "random"] = "numpy.random"
    return out


def _host_state_names(tree: ast.Module) -> Dict[str, str]:
    """Local alias -> origin for names bound to serving host state:
    imports of the registered modules or their stateful classes, plus
    module-level instances constructed from one (``STATS =
    ServingStats()``)."""
    names: Dict[str, str] = {}
    for node in ast.walk(tree):
        if not (isinstance(node, ast.ImportFrom) and node.module
                and not node.level):
            continue
        if node.module in _HOST_STATE_MODULES:
            for a in node.names:
                if a.name != "*":
                    names[a.asname or a.name] = \
                        f"{node.module}.{a.name}"
        elif node.module.split(".")[0] == _PKG:
            for a in node.names:
                full = f"{node.module}.{a.name}"
                if full in _HOST_STATE_MODULES \
                        or a.name in _HOST_STATE_SYMBOLS:
                    names[a.asname or a.name] = full
    if not names:
        return names
    for node in tree.body:  # module-level singletons only
        if isinstance(node, ast.Assign):
            targets, value = node.targets, node.value
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            targets, value = [node.target], node.value
        else:
            continue
        if isinstance(value, ast.Call) and call_name(value) in names:
            for t in targets:
                if isinstance(t, ast.Name):
                    names[t.id] = f"{names[call_name(value)]} instance"
    return names


def _function_table(tree: ast.Module) -> Dict[str, ast.FunctionDef]:
    table: Dict[str, ast.FunctionDef] = {}
    for n in ast.walk(tree):
        if isinstance(n, ast.FunctionDef):
            table.setdefault(n.name, n)
    return table


def _resolves(node: ast.AST, origins: Dict[str, str],
              targets: Set[str]) -> bool:
    return dotted(node, origins) in targets


def _decorator_is_root(dec: ast.AST, origins: Dict[str, str]) -> bool:
    if _resolves(dec.func if isinstance(dec, ast.Call) else dec, origins,
                 _ROOT_DECORATORS):
        return True
    # @functools.partial(torch.compile, mode=...)
    return isinstance(dec, ast.Call) and call_name(dec) == "partial" \
        and bool(dec.args) \
        and _resolves(dec.args[0], origins, _ROOT_DECORATORS)


def _root_args(node: ast.Call) -> List[ast.AST]:
    """The callables a root call receives: its positional arguments,
    through ``partial(fn, ...)`` and tuples/lists of callables."""
    out: List[ast.AST] = []
    stack = list(node.args)
    while stack:
        a = stack.pop(0)
        if isinstance(a, ast.Call) and call_name(a) == "partial":
            stack.extend(a.args[:1])
        elif isinstance(a, (ast.Tuple, ast.List)):
            stack.extend(a.elts)
        else:
            out.append(a)
    return out


_ROOT_TAILS = {d.rsplit(".", 1)[1] for d in _ROOT_CALLS}


class _Module:
    """One walk of a module: its import origins, function table, the
    calls that resolve to a root, and whether it can hold a capture."""

    def __init__(self, tree: ast.Module):
        self.tree = tree
        self.origins = import_origins(tree)
        self.table = _function_table(tree)
        self.root_calls: List[ast.Call] = []
        self.captures = False
        for n in ast.walk(tree):
            if not isinstance(n, ast.Call):
                continue
            name = call_name(n)
            if name in _ROOT_TAILS \
                    and _resolves(n.func, self.origins, _ROOT_CALLS):
                self.root_calls.append(n)
            elif name in ("graph", "capture_begin"):
                self.captures = True


def _capture_regions(tree: ast.Module, origins: Dict[str, str]
                     ) -> List[Tuple[str, List[ast.stmt]]]:
    """(enclosing function name, captured statements) for every
    ``with torch.cuda.graph(...)`` body and ``capture_begin()`` ..
    ``capture_end()`` run of statements."""
    out: List[Tuple[str, List[ast.stmt]]] = []

    def marks(stmt: ast.stmt, name: str) -> bool:
        return isinstance(stmt, ast.Expr) \
            and isinstance(stmt.value, ast.Call) \
            and isinstance(stmt.value.func, ast.Attribute) \
            and stmt.value.func.attr == name

    def visit(node: ast.AST, owner: str) -> None:
        for field in ("body", "orelse", "finalbody"):
            stmts = getattr(node, field, None)
            if not isinstance(stmts, list):
                continue
            begin: Optional[int] = None
            for i, stmt in enumerate(stmts):
                if marks(stmt, "capture_begin"):
                    begin = i
                elif marks(stmt, "capture_end") and begin is not None:
                    out.append((owner, stmts[begin + 1:i]))
                    begin = None
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                visit(child, child.name)
                continue
            if isinstance(child, (ast.With, ast.AsyncWith)) and any(
                    isinstance(i.context_expr, ast.Call) and _resolves(
                        i.context_expr.func, origins, _GRAPH_CONTEXTS)
                    for i in child.items):
                out.append((owner, child.body))
            visit(child, owner)

    visit(tree, "<module>")
    return out


def _calls(node: ast.AST) -> Set[str]:
    out: Set[str] = set()
    for n in ast.walk(node):
        if isinstance(n, ast.Name):
            # a call or a bare reference (closure capture, callback arg)
            out.add(n.id)
    return out


def _external_roots(mod: _Module) -> Set[Tuple[str, str]]:
    """(dotted module, function name) pairs this module hands to a root
    call — roots it creates in OTHER files."""
    imports = {local: origin.rsplit(".", 1) for local, origin
               in mod.origins.items() if origin.split(".")[0] == _PKG
               and "." in origin}
    out: Set[Tuple[str, str]] = set()
    if not imports:
        return out
    for call in mod.root_calls:
        for a in _root_args(call):
            if isinstance(a, ast.Name) and a.id in imports:
                out.add(tuple(imports[a.id]))
    return out


def _resolve_module(dotted_name: str, trees: Dict[str, ast.Module]) -> str:
    rel = dotted_name.replace(".", os.sep)
    suffixes = (os.sep + rel + ".py",
                os.sep + rel + os.sep + "__init__.py")
    for path in trees:
        if path.endswith(suffixes):
            return path
    return ""


def check_files(trees: Dict[str, ast.Module]) -> List[Finding]:
    """Project pass: per-module hygiene with cross-module root
    propagation (the only way ``checkpoint(imported_fn, ...)`` can
    taint the defining module)."""
    mods = {path: _Module(tree) for path, tree in trees.items()}
    extra: Dict[str, Set[str]] = {}
    for mod in mods.values():
        for dotted_mod, fname in _external_roots(mod):
            target = _resolve_module(dotted_mod, trees)
            if target:
                extra.setdefault(target, set()).add(fname)
    findings: List[Finding] = []
    for path in sorted(trees):
        findings.extend(_check(mods[path], path,
                               sorted(extra.get(path, ()))))
    return findings


def check_module(tree: ast.Module, path: str,
                 extra_roots: Iterable[str] = ()) -> List[Finding]:
    return _check(_Module(tree), path, extra_roots)


def _check(mod: _Module, path: str,
           extra_roots: Iterable[str]) -> List[Finding]:
    tree, origins, table = mod.tree, mod.origins, mod.table
    frontier = [fn.name for fn in table.values()
                if any(_decorator_is_root(d, origins)
                       for d in fn.decorator_list)]
    for call in mod.root_calls:
        frontier += [a.id for a in _root_args(call)
                     if isinstance(a, ast.Name)]
    frontier.extend(extra_roots)
    regions = _capture_regions(tree, origins) if mod.captures else []
    if not frontier and not regions:
        return []   # nothing captured, compiled or recomputed here
    host = _host_modules(tree)
    host_state = _host_state_names(tree)
    for _, stmts in regions:
        for s in stmts:
            frontier.extend(_calls(s))

    reachable: Set[str] = set()
    while frontier:
        name = frontier.pop()
        if name in reachable or name not in table:
            continue
        reachable.add(name)
        frontier.extend(_calls(table[name]) & set(table))

    findings: List[Finding] = []
    seen: Set[int] = set()
    scopes: List[Tuple[str, Sequence[ast.AST], str]] = [
        (name, [table[name]], "reachable from a graph-capture, compile "
         "or checkpoint root") for name in sorted(reachable)]
    scopes += [(owner, stmts, "captured by a CUDA graph")
               for owner, stmts in regions]
    for name, nodes, where in scopes:
        for top in nodes:
            body = ast.walk(top) if isinstance(top, ast.FunctionDef) \
                else [top, *walk_scope(top)]
            for node in body:
                finding = _violation(node, name, where, host, host_state,
                                     path)
                if finding is not None and node.lineno not in seen:
                    seen.add(node.lineno)
                    findings.append(finding)
    return findings


def _violation(node: ast.AST, name: str, where: str,
               host: Dict[str, str], host_state: Dict[str, str],
               path: str) -> Optional[Finding]:
    if isinstance(node, ast.Global):
        return Finding(
            "APX402", path, node.lineno,
            f"'global {', '.join(node.names)}' inside '{name}', {where} "
            "— the write happens once for every replay, or twice for one "
            "step under a recompute")
    if host_state and isinstance(node, (ast.Attribute, ast.Name)):
        chain = attr_chain(node)
        if chain and chain[0] in host_state:
            return Finding(
                "APX401", path, node.lineno,
                f"serving host state '{'.'.join(chain)}' "
                f"({host_state[chain[0]]}) inside '{name}', {where} — "
                "fault schedules and ServingStats counters mutate between "
                "ticks; a captured or recomputed read sees a stale or "
                "different value")
        return None
    if not isinstance(node, ast.Call):
        return None
    chain = attr_chain(node.func)
    if not chain or chain[0] not in host:
        return None
    root = host[chain[0]]
    full = [root] + chain[1:]
    bad = (root in ("time", "random", "numpy.random")
           or (root == "numpy" and len(full) > 1 and full[1] == "random")
           or (root == "datetime" and full[-1] in ("now", "today",
                                                   "utcnow")))
    if not bad:
        return None
    return Finding(
        "APX401", path, node.lineno,
        f"host-state read '{'.'.join(chain)}' inside '{name}', {where} — "
        "a replay repeats the captured value and a recompute reads a new "
        "one")

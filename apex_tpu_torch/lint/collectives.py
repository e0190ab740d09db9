"""Collective-order and axis-resolution checks (APX201, APX202), in the
port's idiom.

The port runs each rank in its own process, and every rank must issue
the same group collectives in the same order: an ``all_reduce`` that
only some ranks reach is a hang, not an error message. The port's
collectives go through ``tensor_parallel.mappings``: ``collective(kind,
x, group, members, ...)``, ``shift``, ``all_to_all`` and the seven region
mappings (whose forward or backward all-reduces, gathers or
reduce-scatters over the ``model`` axis), and through raw
``torch.distributed`` calls.

**APX201** — the dangerous shape is a *rank-dependent* conditional (an
``if`` whose predicate reads ``dist.get_rank()``, a ``parallel_state``
rank or stage query such as ``get_tensor_model_parallel_rank()`` or
``is_pipeline_first_stage()``, ``members.index(...)``, or a name or
attribute called ``rank`` / ``*_rank`` / ``stage`` / ``*_stage``, or a
local bound to one) whose branches issue different collective
sequences. The check symbolically executes each function body, building
the set of collective sequences along every path (early returns end a
path; calls of module-local functions, and of methods defined in the
module on a local name such as ``self`` or ``wire``, contribute their
sequence when it is unambiguous), and compares the branches at each
rank-dependent split. Config-dependent branches (``if n == 1:``,
``if staged:``) are identical on every rank and are not compared.

The ordered events are ``collective("<kind>", ...)`` with a literal
kind, ``shift``, ``all_to_all``, the region mappings, and
``dist.all_reduce`` / ``broadcast`` / ``barrier`` / ``reduce`` /
``gather`` / ``scatter`` / ``all_gather*`` / ``reduce_scatter*`` /
``all_to_all*`` / ``*_object(_list)``, each tagged with its group (or
axis) as written.

Point-to-point calls (``dist.send`` / ``recv`` / ``isend`` / ``irecv``)
are one-sided by design — the page handoff sends on the source rank and
receives on the destination (``serving/transfer.py``: ``Wire.move``'s
``if``/``elif`` on the rank, ``PageTransfer._cross``'s separate tests of
the source and destination sets) — so they stay out of the compared
sequence. Their rule: within one function, a send on a group under a
rank-dependent conditional needs a receive on the same group under a
rank-dependent conditional of that function, and a receive a send; an
exchange with no partner there is one-sided, APX201 at the first split
that holds it. An ``if``/``elif`` chain on the rank is one split.

**APX202** — every axis name handed to ``shift(x, axis, ...)``,
``all_to_all(x, axis, ...)``, ``_axis(axis)``, ``axis_group(axis)``,
``mesh.groups[axis]`` or ``mesh.members(axis)`` must resolve to a
``parallel_state`` mesh axis (``DATA_AXIS`` ... ``TENSOR_AXIS``, read
from the port's ``transformer/parallel_state.py`` with ``ast``) or to an
axis literally declared in the same file (``make_mesh`` / ``Mesh`` /
``PartitionSpec`` / ``P`` strings, ``axis_name(s)=``). Axis arguments
resolve through string literals, ``ps.X_AXIS`` constants, module-level
aliases, parameter defaults and single local assignments; anything
unresolvable is skipped, never guessed.
"""

import ast
import os
import re
from typing import Dict, List, Optional, Set, Tuple

from apex_tpu_torch.lint import Finding
from apex_tpu_torch.lint.astutil import (
    attr_chain,
    call_name,
    dotted,
    import_origins,
    walk_scope,
)

_DIST = "torch.distributed"
_DIST_EXACT = {"all_reduce", "broadcast", "barrier", "reduce", "gather",
               "scatter", "monitored_barrier"}
_DIST_PREFIX = ("all_gather", "reduce_scatter", "all_to_all")
_DIST_SUFFIX = ("_object", "_object_list")
_P2P = {"send": "send", "isend": "send", "recv": "recv", "irecv": "recv"}
_REGIONS = {
    "copy_to_tensor_model_parallel_region",
    "reduce_from_tensor_model_parallel_region",
    "scatter_to_tensor_model_parallel_region",
    "gather_from_tensor_model_parallel_region",
    "scatter_to_sequence_parallel_region",
    "gather_from_sequence_parallel_region",
    "reduce_scatter_to_sequence_parallel_region",
}
#: axis-consuming calls checked by APX202 -> position of the axis
_AXIS_ARG_POS = {"shift": 1, "all_to_all": 1, "_axis": 0,
                 "axis_group": 0, "members": 0}

_RANKISH_NAMES = re.compile(r"(^|_)(rank|stage)(_|$)")
_MAX_PATHS = 64


def _parallel_state_axes() -> Set[str]:
    """Mesh axis names, read from the port's parallel_state.py AST."""
    ps_path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "transformer", "parallel_state.py")
    axes: Set[str] = set()
    try:
        with open(ps_path, "r", encoding="utf-8") as fh:
            tree = ast.parse(fh.read())
    except (OSError, SyntaxError):
        return {"data", "pipe", "context", "model"}
    for node in tree.body:
        if not isinstance(node, ast.Assign):
            continue
        for t in node.targets:
            if (isinstance(t, ast.Name) and t.id.endswith("_AXIS")
                    and isinstance(node.value, ast.Constant)
                    and isinstance(node.value.value, str)):
                _AXIS_CONSTANTS[t.id] = node.value.value
                axes.add(node.value.value)
    return axes or {"data", "pipe", "context", "model"}


_AXIS_CONSTANTS: Dict[str, str] = {}  # e.g. TENSOR_AXIS -> "model"
_VALID_AXES: Optional[Set[str]] = None


def _valid_axes() -> Set[str]:
    global _VALID_AXES
    if _VALID_AXES is None:
        _VALID_AXES = _parallel_state_axes()
    return _VALID_AXES


def _local_axes(tree: ast.Module) -> Set[str]:
    """Axis names declared in this file: strings inside Mesh()/P()/
    PartitionSpec()/make_mesh() calls and axis_name(s)= kwargs."""
    axes: Set[str] = set()

    def strings_under(node):
        for n in ast.walk(node):
            if isinstance(n, ast.Constant) and isinstance(n.value, str):
                axes.add(n.value)

    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        if call_name(node) in ("Mesh", "make_mesh", "P", "PartitionSpec"):
            strings_under(node)
        for kw in node.keywords:
            if kw.arg in ("axis_name", "axis_names"):
                strings_under(kw.value)
    return axes


class _Env:
    """Name -> axis-string resolution context for one function, and the
    module's import origins."""

    def __init__(self, module_aliases: Dict[str, str],
                 origins: Dict[str, str]):
        self.names: Dict[str, str] = dict(module_aliases)
        self.origins = origins
        self.rank_vars: Set[str] = set()
        # (p2p kind, group) -> line of the first rank split issuing it
        self.p2p: Dict[_Event, int] = {}


def _module_aliases(tree: ast.Module) -> Dict[str, str]:
    out: Dict[str, str] = {}
    for node in tree.body:
        if not (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)):
            continue
        val = _resolve_axis_expr(node.value, None)
        if val is not None:
            out[node.targets[0].id] = val
    return out


def _resolve_axis_expr(node: ast.AST,
                       env: Optional[_Env]) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    if isinstance(node, ast.Attribute):
        return _AXIS_CONSTANTS.get(node.attr)
    if isinstance(node, ast.Name):
        if node.id in _AXIS_CONSTANTS:
            return _AXIS_CONSTANTS[node.id]
        if env is not None:
            return env.names.get(node.id)
    return None


def _is_dist(call: ast.Call, env: _Env) -> Optional[str]:
    """The torch.distributed function a call resolves to, or None."""
    full = dotted(call.func, env.origins)
    if full and full.startswith(_DIST + ".") and full.count(".") == 2:
        return full.rsplit(".", 1)[1]
    return None


def _dist_ordered(name: str) -> bool:
    return name in _DIST_EXACT or name.startswith(_DIST_PREFIX) \
        or name.endswith(_DIST_SUFFIX)


def _axis_nodes(call: ast.Call, env: _Env) -> Optional[ast.AST]:
    """The axis argument of an APX202 call (not of a dist function)."""
    name = call_name(call)
    if name not in _AXIS_ARG_POS or _is_dist(call, env):
        return None
    if name == "members" and not isinstance(call.func, ast.Attribute):
        return None
    pos = _AXIS_ARG_POS[name]
    if len(call.args) > pos:
        return call.args[pos]
    for kw in call.keywords:
        if kw.arg in ("axis", "axis_name"):
            return kw.value
    return None


def _seed_env(fn: ast.FunctionDef, env: _Env) -> None:
    """Parameter defaults and simple local assigns, for axis resolution
    and rank-variable tracking."""
    a = fn.args
    pos = a.posonlyargs + a.args
    for param, default in zip(pos[len(pos) - len(a.defaults):], a.defaults):
        v = _resolve_axis_expr(default, env)
        if v is not None:
            env.names[param.arg] = v
    for param, default in zip(a.kwonlyargs, a.kw_defaults):
        if default is not None:
            v = _resolve_axis_expr(default, env)
            if v is not None:
                env.names[param.arg] = v
    for node in walk_scope(fn):
        if not (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)):
            continue
        tgt = node.targets[0].id
        v = _resolve_axis_expr(node.value, env)
        if v is not None:
            env.names.setdefault(tgt, v)
        if _is_rankish(node.value, env):
            env.rank_vars.add(tgt)


def _is_rankish(expr: ast.AST, env: _Env) -> bool:
    for n in ast.walk(expr):
        if isinstance(n, ast.Name):
            if n.id in env.rank_vars or _RANKISH_NAMES.search(n.id):
                return True
        elif isinstance(n, ast.Attribute):
            if _RANKISH_NAMES.search(n.attr):
                return True
        elif isinstance(n, ast.Call) and call_name(n) == "index" \
                and isinstance(n.func, ast.Attribute):
            chain = attr_chain(n.func.value)
            if chain and ("members" in chain[-1] or "ranks" in chain[-1]):
                return True
    return False


# -- path-sensitive collective sequences ------------------------------------

_Event = Tuple[str, str]
_PathSet = Set[Tuple[_Event, ...]]


class _TooManyPaths(Exception):
    pass


def _tag(node: Optional[ast.AST], env: _Env) -> str:
    if node is None:
        return ""
    axis = _resolve_axis_expr(node, env)
    return axis if axis is not None else ast.unparse(node)


def _call_event(node: ast.Call, env: _Env) -> Optional[_Event]:
    """The collective event of one call, or None."""
    dist_name = _is_dist(node, env)
    if dist_name is not None:
        group = next((kw.value for kw in node.keywords
                      if kw.arg == "group"), None)
        if dist_name in _P2P:
            return (f"p2p:{_P2P[dist_name]}", _tag(group, env))
        if _dist_ordered(dist_name):
            return (f"dist.{dist_name}", _tag(group, env))
        return None
    name = call_name(node)
    if name == "collective" and node.args \
            and isinstance(node.args[0], ast.Constant) \
            and isinstance(node.args[0].value, str):
        group = node.args[2] if len(node.args) > 2 else next(
            (kw.value for kw in node.keywords if kw.arg == "group"), None)
        return (node.args[0].value, _tag(group, env))
    if name in ("shift", "all_to_all"):
        axis = _axis_nodes(node, env)
        return (name, _tag(axis, env))
    if name in _REGIONS:
        return (name, "model")
    return None


def _local_callee(node: ast.Call, defs: "_Defs"
                  ) -> Optional[ast.FunctionDef]:
    f = node.func
    if isinstance(f, ast.Name):
        return defs.functions.get(f.id)
    if isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name):
        return defs.methods.get(f.attr)
    return None


def _expr_events(node: ast.AST, env: _Env,
                 defs: Dict[str, ast.FunctionDef],
                 depth: int) -> List[_Event]:
    """Collective events issued while evaluating an expression, in
    source order. Calls to local functions contribute their (merged)
    sequences only when unambiguous; unknown callees are opaque."""
    events: List[_Event] = []
    for n in ast.iter_child_nodes(node):
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.Lambda, ast.ClassDef)):
            continue
        events.extend(_expr_events(n, env, defs, depth))
    if isinstance(node, ast.Call):
        ev = _call_event(node, env)
        if ev is not None:
            events.append(ev)
        else:
            sub = _local_callee(node, defs)
            if sub is not None and depth < 4:
                seqs = _function_paths(sub, env, defs, depth + 1)
                if len(seqs) == 1:
                    events.extend(next(iter(seqs)))
                # divergent callees are reported at their own definition
    return events


def _chain(stmt: ast.If, env: _Env) -> List[Tuple[List[ast.expr],
                                                   List[ast.stmt]]]:
    """The branches of an if/elif chain whose every test is
    rank-dependent (the last one the final else, maybe empty), each
    with the elif tests evaluated before it is reached."""
    branches = [([], stmt.body)]
    tests: List[ast.expr] = []
    rest = stmt.orelse
    while len(rest) == 1 and isinstance(rest[0], ast.If) \
            and _is_rankish(rest[0].test, env):
        tests = tests + [rest[0].test]
        branches.append((tests, rest[0].body))
        rest = rest[0].orelse
    branches.append((tests, rest))
    return branches


def _ordered(paths: _PathSet) -> Set[Tuple[_Event, ...]]:
    return {tuple(e for e in p if not e[0].startswith("p2p:"))
            for p in paths}


def _p2p(paths: _PathSet) -> Set[_Event]:
    return {e for p in paths for e in p if e[0].startswith("p2p:")}


def _check_split(stmt: ast.If, all_paths: List[_PathSet], env, findings,
                 path) -> None:
    """APX201 at a rank-dependent split, given each branch's paths: one
    ordered sequence set on every branch; its p2p ops noted for the
    function's pairing."""
    seqs = [_ordered(p) for p in all_paths]
    if any(s != seqs[0] for s in seqs[1:]):
        findings.append(Finding(
            "APX201", path, stmt.lineno,
            "collective sequence differs between the branches of this "
            "rank-dependent conditional ("
            + " vs ".join(_describe(s) for s in seqs[:3])
            + ") — ranks would issue mismatched collectives"))
    for op in sorted(set().union(*(_p2p(p) for p in all_paths))):
        env.p2p.setdefault(op, stmt.lineno)


def _check_p2p(env: _Env, path: str) -> List[Finding]:
    """The function's pairing rule for point-to-point ops (module doc)."""
    out = []
    for (kind, group), line in sorted(env.p2p.items()):
        partner = "p2p:recv" if kind == "p2p:send" else "p2p:send"
        if (partner, group) not in env.p2p:
            out.append(Finding(
                "APX201", path, line,
                f"{kind[4:]} on group {group or 'WORLD'} under this "
                f"rank-dependent conditional has no matching "
                f"{partner[4:]} on that group under any rank split of the "
                "function — the point-to-point exchange is one-sided"))
    return out


def _stmt_paths(stmts, env, defs, depth, findings, path):
    """Returns (open_paths, closed_paths) for a statement list."""
    open_paths: _PathSet = {()}
    closed: _PathSet = set()

    def extend(events: List[_Event]):
        nonlocal open_paths
        if events:
            open_paths = {p + tuple(events) for p in open_paths}

    for stmt in stmts:
        if isinstance(stmt, ast.If):
            extend(_expr_events(stmt.test, env, defs, depth))
            split = _is_rankish(stmt.test, env)
            # a split's rank-dependent elifs are branches of the split
            branches = _chain(stmt, env) if split else [
                ([], stmt.body), ([], stmt.orelse)]
            b_open: _PathSet = set()
            b_closed: _PathSet = set()
            split_paths = []
            for tests, body in branches:
                o, c = _stmt_paths(body, env, defs, depth, findings, path)
                split_paths.append(o | c)
                pre = tuple(e for t in tests
                            for e in _expr_events(t, env, defs, depth))
                b_open |= {pre + b for b in o}
                b_closed |= {pre + b for b in c}
            if split:
                _check_split(stmt, split_paths, env, findings, path)
            closed |= {p + b for p in open_paths for b in b_closed}
            open_paths = {p + b for p in open_paths for b in b_open}
        elif isinstance(stmt, ast.Return):
            if stmt.value is not None:
                extend(_expr_events(stmt.value, env, defs, depth))
            closed |= open_paths
            open_paths = set()
            break
        elif isinstance(stmt, (ast.For, ast.While)):
            if isinstance(stmt, ast.For):
                extend(_expr_events(stmt.iter, env, defs, depth))
            else:
                extend(_expr_events(stmt.test, env, defs, depth))
            b_open, b_closed = _stmt_paths(stmt.body, env, defs, depth,
                                           findings, path)
            closed |= {p + b for p in open_paths for b in b_closed}
            open_paths = {p + b for p in open_paths for b in b_open}
        elif isinstance(stmt, (ast.With, ast.Try)):
            if isinstance(stmt, ast.With):
                for item in stmt.items:
                    extend(_expr_events(item.context_expr, env, defs,
                                        depth))
            b_open, b_closed = _stmt_paths(stmt.body, env, defs, depth,
                                           findings, path)
            closed |= {p + b for p in open_paths for b in b_closed}
            open_paths = {p + b for p in open_paths for b in b_open}
        elif isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.ClassDef)):
            continue
        else:
            extend(_expr_events(stmt, env, defs, depth))
        if len(open_paths) + len(closed) > _MAX_PATHS:
            raise _TooManyPaths()
    return open_paths, closed


def _describe(paths) -> str:
    names = sorted({",".join(e[0] for e in p) or "<none>" for p in paths})
    return "{" + " | ".join(names[:4]) + "}"


class _Defs:
    """The module's functions by name, and the methods of its classes
    by name (the first definition of each wins)."""

    def __init__(self, tree: ast.Module):
        self.functions: Dict[str, ast.FunctionDef] = {}
        self.methods: Dict[str, ast.FunctionDef] = {}
        for n in ast.walk(tree):
            if isinstance(n, ast.FunctionDef):
                self.functions.setdefault(n.name, n)
            elif isinstance(n, ast.ClassDef):
                for m in n.body:
                    if isinstance(m, ast.FunctionDef):
                        self.methods.setdefault(m.name, m)


def _function_paths(fn, env, defs, depth) -> _PathSet:
    sub_env = _Env(env.names, env.origins)
    _seed_env(fn, sub_env)
    try:
        o, c = _stmt_paths(fn.body, sub_env, defs, depth, [], "")
    except (_TooManyPaths, RecursionError):
        return {()}
    return (o | c) or {()}


def _uses_collectives(tree: ast.Module, origins: Dict[str, str]) -> bool:
    names = set(_AXIS_ARG_POS) | _REGIONS | {"collective"}
    for n in ast.walk(tree):
        if isinstance(n, ast.Call):
            full = dotted(n.func, origins)
            if call_name(n) in names or (full or "").startswith(_DIST):
                return True
        elif isinstance(n, ast.Attribute) and n.attr == "groups":
            return True
    return False


# -- module entry ------------------------------------------------------------

def check_module(tree: ast.Module, path: str) -> List[Finding]:
    origins = import_origins(tree)
    # prescan: a module with no collective or axis call can produce no
    # finding, so skip the path enumeration outright
    if not _uses_collectives(tree, origins):
        return []
    findings: List[Finding] = []
    valid = _valid_axes() | _local_axes(tree)   # reads the axis constants
    aliases = _module_aliases(tree)
    defs = _Defs(tree)

    # APX202: every resolvable axis argument must name a mesh axis
    envs = {}
    for fn in defs.functions.values():
        env = envs[id(fn)] = _Env(aliases, origins)
        _seed_env(fn, env)
        for node in walk_scope(fn):
            axis = None
            if isinstance(node, ast.Call):
                axis = _axis_nodes(node, env)
            elif isinstance(node, ast.Subscript) \
                    and isinstance(node.value, ast.Attribute) \
                    and node.value.attr == "groups":
                axis = node.slice
            if axis is None:
                continue
            ax = _resolve_axis_expr(axis, env)
            if ax is not None and ax not in valid:
                findings.append(Finding(
                    "APX202", path, node.lineno,
                    f"axis {ax!r} is not a parallel_state mesh axis "
                    f"(known: {sorted(valid)[:8]})"))

    # APX201: rank-dependent branch divergence, per function (only a
    # function with a rank-dependent split can diverge)
    for fn in defs.functions.values():
        env = envs[id(fn)]
        if not any(isinstance(n, ast.If) and _is_rankish(n.test, env)
                   for n in walk_scope(fn)):
            continue
        local: List[Finding] = []
        try:
            _stmt_paths(fn.body, env, defs, 0, local, path)
        except (_TooManyPaths, RecursionError):
            continue
        findings.extend(local)
        findings.extend(_check_p2p(env, path))
    return findings

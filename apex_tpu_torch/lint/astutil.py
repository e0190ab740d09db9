"""Small shared AST helpers for the port's apxlint checkers (the JAX
package's helpers, with the same results, plus the import resolution
the torch-idiom rules need).

Everything here is deliberately conservative: helpers return ``None``
for anything they cannot resolve statically, and every checker treats
``None`` as "skip, don't guess" — a lint finding must never rest on a
heuristic that could misread the program.
"""

import ast
from typing import Any, Dict, Iterator, List, Optional


def call_name(node: ast.Call) -> Optional[str]:
    """Trailing name of the called function: ``pl.pallas_call`` ->
    ``pallas_call``, ``psum`` -> ``psum``."""
    f = node.func
    if isinstance(f, ast.Attribute):
        return f.attr
    if isinstance(f, ast.Name):
        return f.id
    return None


def attr_chain(node: ast.AST) -> Optional[List[str]]:
    """``np.random.rand`` -> ["np", "random", "rand"]; None if the chain
    is rooted in anything but a plain name."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return parts[::-1]
    return None


def kwarg(node: ast.Call, name: str) -> Optional[ast.AST]:
    for kw in node.keywords:
        if kw.arg == name:
            return kw.value
    return None


def static_len(node: Optional[ast.AST]) -> Optional[int]:
    """Length of a list/tuple expression when statically countable.

    Handles the spec-building idioms of the kernel call sites:
    ``[a] + [b] * 3`` and a bare ``BlockSpec(...)`` call (a single
    spec counts as length 1). Anything else -> None.
    """
    if node is None:
        return None
    if isinstance(node, (ast.List, ast.Tuple)):
        if any(isinstance(e, ast.Starred) for e in node.elts):
            return None
        return len(node.elts)
    if isinstance(node, ast.BinOp):
        if isinstance(node.op, ast.Add):
            left, right = static_len(node.left), static_len(node.right)
            if left is None or right is None:
                return None
            return left + right
        if isinstance(node.op, ast.Mult):
            seq, mult = node.left, node.right
            if isinstance(seq, ast.Constant):
                seq, mult = mult, seq
            n = static_len(seq)
            if (n is not None and isinstance(mult, ast.Constant)
                    and isinstance(mult.value, int)):
                return n * mult.value
            return None
    if isinstance(node, ast.Call):
        return 1  # a single BlockSpec(...) / ShapeDtypeStruct(...)
    return None


def static_elements(node: Optional[ast.AST]) -> Optional[List[ast.AST]]:
    """The element expressions of a statically countable sequence, with
    ``[x] * 3`` expanded by repetition. None if not countable."""
    if node is None:
        return None
    if isinstance(node, (ast.List, ast.Tuple)):
        if any(isinstance(e, ast.Starred) for e in node.elts):
            return None
        return list(node.elts)
    if isinstance(node, ast.BinOp):
        if isinstance(node.op, ast.Add):
            left = static_elements(node.left)
            right = static_elements(node.right)
            if left is None or right is None:
                return None
            return left + right
        if isinstance(node.op, ast.Mult):
            seq, mult = node.left, node.right
            if isinstance(seq, ast.Constant):
                seq, mult = mult, seq
            elems = static_elements(seq)
            if (elems is not None and isinstance(mult, ast.Constant)
                    and isinstance(mult.value, int)):
                return elems * mult.value
            return None
    if isinstance(node, ast.Call):
        return [node]
    return None


def literal_strings(node: ast.AST) -> Optional[Any]:
    """Evaluate an expression built of string literals and set algebra:
    set/frozenset/list/tuple literals, ``frozenset({...})``, and ``|`` /
    ``-`` over those. Returns a frozenset of strings, or None."""
    if isinstance(node, (ast.Set, ast.List, ast.Tuple)):
        vals = []
        for e in node.elts:
            if not (isinstance(e, ast.Constant) and isinstance(e.value, str)):
                return None
            vals.append(e.value)
        return frozenset(vals)
    if isinstance(node, ast.Call) and call_name(node) in ("frozenset", "set"):
        if len(node.args) == 1 and not node.keywords:
            return literal_strings(node.args[0])
        if not node.args and not node.keywords:
            return frozenset()
        return None
    if isinstance(node, ast.BinOp) and isinstance(node.op, (ast.BitOr,
                                                            ast.Sub)):
        left = literal_strings(node.left)
        right = literal_strings(node.right)
        if left is None or right is None:
            return None
        return left | right if isinstance(node.op, ast.BitOr) else \
            left - right
    return None


def walk_scope(node: ast.AST) -> Iterator[ast.AST]:
    """Like ``ast.walk`` but does not descend into nested function or
    class scopes (their statements execute elsewhere, if at all)."""
    stack = list(ast.iter_child_nodes(node))
    while stack:
        child = stack.pop()
        yield child
        if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.Lambda, ast.ClassDef)):
            continue
        stack.extend(ast.iter_child_nodes(child))


def functions_in(tree: ast.AST) -> List[ast.FunctionDef]:
    """Every FunctionDef in the module, including nested ones."""
    return [n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef)]


def import_origins(tree: ast.AST) -> Dict[str, str]:
    """Local name -> dotted origin for the module's absolute imports:
    ``import torch.distributed as dist`` -> {"dist":
    "torch.distributed"}, ``import torch.utils.checkpoint`` ->
    {"torch": "torch"}, ``from torch.utils.checkpoint import checkpoint
    as ck`` -> {"ck": "torch.utils.checkpoint.checkpoint"}. Relative
    imports are left out (None-means-skip: their package is not
    resolved)."""
    out: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.asname:
                    out[a.asname] = a.name
                else:
                    root = a.name.split(".")[0]
                    out[root] = root
        elif isinstance(node, ast.ImportFrom) and node.module \
                and not node.level:
            for a in node.names:
                if a.name != "*":
                    out[a.asname or a.name] = f"{node.module}.{a.name}"
    return out


def dotted(node: ast.AST, origins: Dict[str, str]) -> Optional[str]:
    """The dotted path an attribute chain or name resolves to through
    the module's imports (``dist.all_reduce`` -> ``torch.distributed.
    all_reduce``); None when its root is not an imported name."""
    chain = attr_chain(node)
    if not chain or chain[0] not in origins:
        return None
    return ".".join([origins[chain[0]]] + chain[1:])

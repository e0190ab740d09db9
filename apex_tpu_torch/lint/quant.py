"""Quantization-contract checks: APX106, in torch terms.

The port's int8 tier (``apex_tpu_torch.quant`` and the int8 paged KV
pool) rests on three numeric invariants that a type checker cannot see
and a tolerance test only catches after the fact. The JAX package pins
them on ``astype`` and ``preferred_element_type``; the port's idiom is
fp32 operands, so the rules read that:

1. **Scales stay fp32.** A per-channel (or per-page-per-head) scale
   rounded through bf16 loses ~5 bits of mantissa and biases every
   dequantized element of its channel the same direction. Flags a store
   into a ``*scale*`` name, attribute, subscript or keyword whose value
   downcasts (``.to(torch.bfloat16)``, ``.to(dtype=torch.float16)``,
   ``.half()``, ``.bfloat16()``, ``.type(torch.half)``) or allocates
   below fp32 (``torch.empty/zeros/ones/full/tensor/..._like(...,
   dtype=torch.bfloat16)``), and a ``*scale*.copy_(<downcast>)``.

2. **Dequant products are fp32.** Inside a function whose name holds
   ``w8`` or ``dequant``, every ``torch.matmul`` / ``@`` / ``mm`` /
   ``bmm`` / ``einsum`` / ``F.linear`` (and the tensor methods
   ``matmul`` / ``mm`` / ``bmm``) takes operands that are provably fp32:
   ``.float()``, ``.double()``, ``.to(torch.float32)``, a ``_dequant`` or
   ``kv_dequantize`` result, fp32 arithmetic of those (with Python
   number constants), a shape-only view of one (``.t()``, ``.abs()``,
   ``.T``, ``.reshape(...)``, a subscript, ...), or a local name every
   binding of which is one of those (a parameter never is). A torch
   product of fp32 operands accumulates in fp32; a bf16 operand gives a
   bf16 product, whatever the weights were dequantized to.

3. **int8 casts round to nearest.** ``.to(torch.int8)`` (or
   ``.type(torch.int8)``, ``.char()``) truncates toward zero; round to
   nearest is what makes whole-page requant idempotent at a fixed scale.
   Flags such a cast in a function that contains no rounding call
   (``torch.round`` / ``.round()`` / ``round_`` / ``rint`` /
   ``nearbyint``).

The CUDA sources under ``csrc/`` are out of scope: this is a Python AST
rule, and the kernels are held to their plain versions on the card.
Anything not statically readable is skipped, never guessed at.
"""

import ast
from typing import Dict, List, Optional, Set

from apex_tpu_torch.lint import Finding
from apex_tpu_torch.lint.astutil import attr_chain, call_name, kwarg

_LOW = {"bfloat16", "float16", "half"}
_FP32 = {"float32", "float", "float64", "double"}
_DTYPES = _LOW | _FP32 | {"int8", "uint8", "int16", "int32", "int64",
                          "long", "int", "bool", "char", "short"}
_VIEWS = {"t", "abs", "transpose", "permute", "reshape", "contiguous",
          "unsqueeze", "squeeze", "clone", "neg", "flatten", "expand",
          "expand_as", "narrow", "view_as", "detach", "__getitem__",
          "mT", "T"}
_ALLOC = {"empty", "zeros", "ones", "full", "tensor", "as_tensor",
          "empty_like", "zeros_like", "ones_like", "full_like",
          "new_empty", "new_zeros", "new_ones", "new_full", "new_tensor"}
_PRODUCTS = {"matmul", "mm", "bmm", "einsum", "linear"}
_ROUND_NAMES = {"round", "round_", "rint", "nearbyint"}
_FP32_PRODUCERS = {"_dequant", "kv_dequantize"}
_DEQUANT_MARKERS = ("w8", "dequant")
_INTEGER_SOURCES = {"randint", "randint_like", "randperm"}


def _dtype_name(node: Optional[ast.AST]) -> Optional[str]:
    """``torch.float32`` -> "float32"; ``"int8"`` -> "int8"; a name that
    is not a dtype (``x.device``) -> None."""
    if node is None:
        return None
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        name = node.value
    else:
        chain = attr_chain(node)
        name = chain[-1] if chain else None
    return name if name in _DTYPES else None


def _cast_dtype(call: ast.Call) -> Optional[str]:
    """The dtype a ``.to(...)`` / ``.type(...)`` call casts to, or a
    dtype method's (``.half()`` -> "float16"); None where the call names
    none (a device move) or is not such a call."""
    if not isinstance(call.func, ast.Attribute):
        return None
    attr = call.func.attr
    if attr in ("half", "bfloat16", "float", "double", "char") \
            and not call.args:
        return {"half": "float16", "char": "int8"}.get(attr, attr)
    if attr not in ("to", "type"):
        return None
    for a in list(call.args) + [kwarg(call, "dtype")]:
        name = _dtype_name(a)
        if name is not None:
            return name
    return None


def _downcasts(expr: ast.AST) -> bool:
    for n in ast.walk(expr):
        if isinstance(n, ast.Call):
            if _cast_dtype(n) in _LOW:
                return True
            if call_name(n) in _ALLOC \
                    and _dtype_name(kwarg(n, "dtype")) in _LOW:
                return True
    return False


def _target_name(t: ast.AST) -> Optional[str]:
    while isinstance(t, ast.Subscript):
        t = t.value
    if isinstance(t, ast.Name):
        return t.id
    if isinstance(t, ast.Attribute):
        return t.attr
    return None


def check_module(tree: ast.Module, path: str) -> List[Finding]:
    findings = _check_scale_stores(tree, path)
    findings.extend(_check_functions(tree, path))
    return findings


def _check_scale_stores(tree: ast.Module, path: str) -> List[Finding]:
    """Rule 1: a ``*scale*`` store, keyword or copy that rounds below
    fp32."""
    findings: List[Finding] = []
    seen: Set[int] = set()

    def emit(line: int, what: str) -> None:
        if line not in seen:
            seen.add(line)
            findings.append(Finding(
                "APX106", path, line,
                f"{what} rounds through or allocates in reduced precision "
                "— quantization scales must stay fp32"))

    for node in ast.walk(tree):
        if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            if node.value is None:
                continue
            for t in targets:
                name = _target_name(t)
                if name and "scale" in name and _downcasts(node.value):
                    emit(node.lineno, f"store into scale '{name}'")
        elif isinstance(node, ast.Call):
            for kw in node.keywords:
                if kw.arg and "scale" in kw.arg and _downcasts(kw.value):
                    emit(node.lineno, f"scale argument '{kw.arg}='")
            if call_name(node) == "copy_" \
                    and isinstance(node.func, ast.Attribute) and node.args:
                name = _target_name(node.func.value)
                if name and "scale" in name and _downcasts(node.args[0]):
                    emit(node.lineno, f"copy into scale '{name}'")
    return findings


def _check_functions(tree: ast.Module, path: str) -> List[Finding]:
    """Rules 2 and 3, both scoped to the innermost enclosing function."""
    findings: List[Finding] = []

    def visit(node: ast.AST, fn: Optional["_Scope"]) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                visit(child, _Scope(child))
                continue
            if fn is not None and (
                    isinstance(child, ast.Call)
                    or (isinstance(child, ast.BinOp)
                        and isinstance(child.op, ast.MatMult))):
                findings.extend(_check_node(child, fn, path))
            visit(child, fn)

    visit(tree, None)
    return findings


class _Scope:
    """One function and, computed on first need, whether it rounds and
    its fp32 local names."""

    def __init__(self, fn: ast.FunctionDef):
        self.fn = fn
        self.dequant = any(m in fn.name for m in _DEQUANT_MARKERS)
        self._rounds: Optional[bool] = None
        self._fp32: Optional[Set[str]] = None

    @property
    def rounds(self) -> bool:
        if self._rounds is None:
            self._rounds = any(
                isinstance(n, ast.Call) and call_name(n) in _ROUND_NAMES
                for n in ast.walk(self.fn))
        return self._rounds

    @property
    def fp32(self) -> Set[str]:
        if self._fp32 is None:
            self._fp32 = _fp32_names(self.fn)
        return self._fp32


def _is_fp32(node: ast.AST, names: Set[str]) -> bool:
    """Is ``node`` provably an fp32 (or wider) tensor? (Rule 2's list.)"""
    if isinstance(node, ast.Name):
        return node.id in names
    if isinstance(node, ast.Subscript):
        return _is_fp32(node.value, names)
    if isinstance(node, ast.Attribute):
        return node.attr in ("T", "mT") and _is_fp32(node.value, names)
    if isinstance(node, ast.IfExp):
        return _is_fp32(node.body, names) and _is_fp32(node.orelse, names)
    if isinstance(node, ast.BinOp):
        sides = (node.left, node.right)
        if isinstance(node.op, ast.MatMult):
            return all(_is_fp32(s, names) for s in sides)
        num = [isinstance(s, ast.Constant)
               and isinstance(s.value, (int, float)) for s in sides]
        return any(_is_fp32(s, names) for s in sides) and all(
            n or _is_fp32(s, names) for s, n in zip(sides, num))
    if isinstance(node, ast.UnaryOp):
        return _is_fp32(node.operand, names)
    if not isinstance(node, ast.Call):
        return False
    if call_name(node) in _FP32_PRODUCERS:
        return True
    if not isinstance(node.func, ast.Attribute):
        return False
    cast = _cast_dtype(node)
    if cast is not None:
        return cast in _FP32
    attr = node.func.attr
    if attr == "to" and not node.args and kwarg(node, "dtype") is None:
        return _is_fp32(node.func.value, names)   # to(device=...)
    return attr in _VIEWS and _is_fp32(node.func.value, names)


def _fp32_names(fn: ast.FunctionDef) -> Set[str]:
    """Local names every binding of which is fp32 (a greatest fixpoint,
    so ``w = w.t() if nk else w`` keeps ``w``); parameters, loop
    targets and unpacked names are never in the set."""
    params = {a.arg for a in fn.args.posonlyargs + fn.args.args
              + fn.args.kwonlyargs}
    params |= {a.arg for a in (fn.args.vararg, fn.args.kwarg) if a}
    values: Dict[str, List[ast.AST]] = {}
    excluded = set(params)
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    values.setdefault(t.id, []).append(node.value)
                else:
                    excluded |= {n.id for n in ast.walk(t)
                                 if isinstance(n, ast.Name)}
        elif isinstance(node, (ast.AugAssign, ast.AnnAssign, ast.For,
                               ast.With, ast.NamedExpr,
                               ast.comprehension)):
            target = getattr(node, "target", None)
            if isinstance(node, ast.With):
                target = ast.Tuple([i.optional_vars for i in node.items
                                    if i.optional_vars is not None])
            if target is not None:
                excluded |= {n.id for n in ast.walk(target)
                             if isinstance(n, ast.Name)}
    names = set(values) - excluded
    while True:
        keep = {n for n in names
                if all(_is_fp32(v, names) for v in values[n])}
        if keep == names:
            return names
        names = keep


def _integer_valued(expr: ast.AST) -> bool:
    """Does the cast's source already hold integers (a ``randint`` draw,
    or a cast to an integer dtype on the way)? Then the int8 cast rounds
    nothing."""
    for n in ast.walk(expr):
        if isinstance(n, ast.Call):
            if call_name(n) in _INTEGER_SOURCES:
                return True
            cast = _cast_dtype(n)
            if cast is not None and cast not in _LOW | _FP32:
                return True
    return False


def _operands(node: ast.AST) -> Optional[List[ast.AST]]:
    """The tensor operands of a product call, or None if it is not one."""
    if isinstance(node, ast.BinOp):
        return [node.left, node.right]
    name = call_name(node)
    if name not in _PRODUCTS:
        return None
    chain = attr_chain(node.func)
    is_module_fn = chain is not None and len(chain) > 1 and chain[0] in (
        "torch", "F", "functional", "nn")
    if name == "einsum":
        return list(node.args[1:])
    if name == "linear":
        return list(node.args[:2]) if is_module_fn else None
    if is_module_fn or isinstance(node.func, ast.Name):
        return list(node.args[:2])
    # a tensor method: a.matmul(b)
    return [node.func.value] + list(node.args[:1])


def _check_node(node: ast.AST, scope: _Scope, path: str) -> List[Finding]:
    findings = []
    fn = scope.fn
    # Rule 2: a product in a dequant function takes fp32 operands
    if scope.dequant:
        ops = _operands(node)
        if ops:
            bad = [ast.unparse(o) for o in ops
                   if not _is_fp32(o, scope.fp32)]
            if bad:
                what = "@" if isinstance(node, ast.BinOp) \
                    else call_name(node)
                findings.append(Finding(
                    "APX106", path, node.lineno,
                    f"{what} in dequant function '{fn.name}' on operand(s) "
                    f"{', '.join(bad)} not provably fp32 — int8 dequant "
                    "products must take fp32 operands (.float(), "
                    "_dequant(...)) so they accumulate in fp32"))
    # Rule 3: an int8 cast without an explicit round in the function
    # (of a source not already integer-valued)
    if isinstance(node, ast.Call) and _cast_dtype(node) == "int8" \
            and not _integer_valued(node.func.value) and not scope.rounds:
        findings.append(Finding(
            "APX106", path, node.lineno,
            f"int8 cast in '{fn.name}' with no rounding call in scope — "
            "int8 quantization must round to nearest (torch.round; "
            "truncation breaks requant idempotence)"))
    return findings

"""AMP op-list coherence checks (APX301-APX304), as in the JAX package:
the rule reads op-name strings, not array code, so it applies to the
port's ``apex_tpu_torch/amp/lists.py`` and its ``cast_args("<op>", ...)``
sites (``amp/autocast.py``) unchanged.

The O1 policy is a three-way partition: every op name consulted through
``amp.autocast.cast_args(op, ...)`` must appear in exactly one of
``FP16_FUNCS`` / ``FP32_FUNCS`` / ``CASTS`` in ``amp/lists.py``, and
every listed op should correspond to an interception site — otherwise
the table silently stops describing the code (the reference repo's
op lists and its monkey-patch sites have exactly this drift failure
mode). Ops carried over from the reference tables that are not yet
routed through ``cast_args`` are declared in an explicit ``UNWIRED``
frozenset in the same module; APX303 fires for any listed op that is
neither wired nor declared, and APX304 fires when a declared-unwired
op gains a call site (the exemption went stale), so drift is loud in
both directions.

Mechanics: any linted file that assigns all three list names with
literal-evaluable sets is treated as a policy module; the intercepted
set is gathered from ``cast_args("<literal>", ...)`` calls in linted
files under the same package root (two directory levels above the
policy module), so test helpers exercising ``cast_args`` directly don't
count as wiring.
"""

import ast
import os
from typing import Dict, List, Tuple

from apex_tpu_torch.lint import Finding
from apex_tpu_torch.lint.astutil import literal_strings

_LIST_NAMES = ("FP16_FUNCS", "FP32_FUNCS", "CASTS")


def _extract_sets(tree: ast.Module):
    """{list_name: {op: lineno}} for literal-evaluable assigns."""
    out: Dict[str, Dict[str, int]] = {}
    for node in tree.body:
        if not (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)):
            continue
        name = node.targets[0].id
        if name not in _LIST_NAMES + ("UNWIRED",):
            continue
        ops = literal_strings(node.value)
        if ops is None:
            continue
        lines: Dict[str, int] = {}
        for n in ast.walk(node.value):
            if isinstance(n, ast.Constant) and isinstance(n.value, str) \
                    and n.value in ops:
                lines.setdefault(n.value, n.lineno)
        for op in ops:
            lines.setdefault(op, node.lineno)
        out[name] = lines
    return out


def _intercepted(trees: Dict[str, ast.Module],
                 root: str) -> Dict[str, Tuple[str, int]]:
    """op -> (path, line) of a cast_args("op", ...) call under root."""
    out: Dict[str, Tuple[str, int]] = {}
    for path, tree in trees.items():
        if not os.path.abspath(path).startswith(root):
            continue
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            name = f.attr if isinstance(f, ast.Attribute) else \
                f.id if isinstance(f, ast.Name) else None
            if name != "cast_args" or not node.args:
                continue
            first = node.args[0]
            if isinstance(first, ast.Constant) and isinstance(first.value,
                                                             str):
                out.setdefault(first.value, (path, node.lineno))
    return out


def check_files(trees: Dict[str, ast.Module]) -> List[Finding]:
    findings: List[Finding] = []
    for path, tree in trees.items():
        sets = _extract_sets(tree)
        if not all(n in sets for n in _LIST_NAMES):
            continue
        pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(path)))
        wired = _intercepted(trees, pkg_root)
        unwired = sets.get("UNWIRED", {})
        listed: Dict[str, List[Tuple[str, int]]] = {}
        for lname in _LIST_NAMES:
            for op, line in sets[lname].items():
                listed.setdefault(op, []).append((lname, line))

        for op, homes in sorted(listed.items()):
            if len(homes) > 1:
                names = "/".join(h[0] for h in homes)
                findings.append(Finding(
                    "APX301", path, homes[0][1],
                    f"op '{op}' appears in multiple policy lists "
                    f"({names}) — policy_for() resolves them in "
                    "declaration order, hiding the later entries"))
            if op not in wired and op not in unwired:
                findings.append(Finding(
                    "APX303", path, homes[0][1],
                    f"op '{op}' is listed but never intercepted via "
                    "cast_args() and not declared in UNWIRED — the "
                    "policy table has drifted from the code"))
        for op, (cpath, cline) in sorted(wired.items()):
            if op not in listed:
                findings.append(Finding(
                    "APX302", cpath, cline,
                    f"cast_args('{op}', ...) has no entry in "
                    "FP16_FUNCS/FP32_FUNCS/CASTS — the op silently "
                    "falls through to 'passthrough'"))
            if op in unwired:
                findings.append(Finding(
                    "APX304", path, unwired[op],
                    f"op '{op}' is declared UNWIRED but is intercepted "
                    f"at {os.path.relpath(cpath)}:{cline} — remove the "
                    "stale exemption"))
    return findings

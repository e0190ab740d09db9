"""APX804 — observe/taxonomy coherence, as in the JAX package (the
port's ``serving/observe.py`` keeps ``PHASES``, ``LIFECYCLE`` and the
metric names).

The observe layer's names are a contract surface twice over: the
deterministic replay tests compare ``tick_stream()`` tuples whose
first element is the event NAME, and the bench/export layer reads
metrics back by name (``registry.get`` / ``quantiles``). Both go
quietly wrong when an emit site drifts from the declared vocabulary —
a span opened under a name missing from ``PHASES`` still records, the
subset assertions in the observe tests still pass (they check against
the UNION of the tuples), and the drift surfaces much later as a
Perfetto track nobody categorised or a quantile read that silently
returns nothing. This check closes the loop statically:

- every ``tracer.begin(...)`` / ``tracer.end(...)`` name must be a
  string literal found in ``PHASES`` or an attribute read ending in
  ``.span`` (the transfer classes' declared span attribute); every
  ``span = "..."`` class attribute must itself be in ``PHASES``;
- every ``tracer.instant(...)`` name must be a literal in
  ``LIFECYCLE``;
- a non-literal name at any of those emit sites is flagged as a
  drifting dynamic name — the vocabulary tuples cannot vouch for a
  name computed at runtime;
- metric registry coherence: names created via ``.counter`` /
  ``.gauge`` / ``.histogram`` must be string literals or f-strings
  with literal structure (``f"{p}_src_bytes_total"`` declares the
  family ``*_src_bytes_total``); a fully dynamic name is flagged.
  Every literal ``registry.get("serving_...")`` /
  ``quantiles("serving_...")`` read-back must match a created literal
  or family — reading a never-created name returns nothing, silently.

The declared tuples are parsed from the serving scope's
``observe.py``; if the scope has none (a fixture mini-repo without an
observe module) the span/instant checks are skipped rather than
guessed at.
"""

import ast
import fnmatch
from typing import Dict, List, Optional, Set, Tuple

from apex_tpu_torch.lint import Finding
from apex_tpu_torch.lint.astutil import call_name
from apex_tpu_torch.lint.determinism.reach import serving_dir


def _declared_tuples(tree: ast.Module) -> Dict[str, Tuple[str, ...]]:
    out: Dict[str, Tuple[str, ...]] = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and node.targets[0].id in ("PHASES", "LIFECYCLE") \
                and isinstance(node.value, ast.Tuple):
            vals = []
            for e in node.value.elts:
                if isinstance(e, ast.Constant) and isinstance(e.value, str):
                    vals.append(e.value)
            out[node.targets[0].id] = tuple(vals)
    return out


def _fstring_pattern(node: ast.JoinedStr) -> Optional[str]:
    """An f-string as an fnmatch pattern — interpolations become ``*``.
    None when there is no literal structure at all to anchor on."""
    parts: List[str] = []
    literal = False
    for v in node.values:
        if isinstance(v, ast.Constant) and isinstance(v.value, str):
            parts.append(v.value)
            literal = True
        else:
            parts.append("*")
    return "".join(parts) if literal else None


def _name_arg(node: ast.Call) -> Optional[ast.AST]:
    if node.args:
        return node.args[0]
    for kw in node.keywords:
        if kw.arg == "name":
            return kw.value
    return None


def check_files(strees: Dict[str, ast.Module]) -> List[Finding]:
    findings: List[Finding] = []

    # group by serving scope so fixture mini-repos resolve against
    # their OWN observe.py, not the real one
    scopes: Dict[str, Dict[str, ast.Module]] = {}
    for path, tree in strees.items():
        scopes.setdefault(serving_dir(path), {})[path] = tree

    for scope in sorted(scopes):
        trees = scopes[scope]
        phases: Optional[Set[str]] = None
        lifecycle: Optional[Set[str]] = None
        for path, tree in trees.items():
            if path.rsplit("/", 1)[-1] == "observe.py":
                decl = _declared_tuples(tree)
                if "PHASES" in decl:
                    phases = set(decl["PHASES"])
                if "LIFECYCLE" in decl:
                    lifecycle = set(decl["LIFECYCLE"])

        created: Set[str] = set()
        families: List[str] = []
        lookups: List[Tuple[str, int, str, str]] = []

        for path in sorted(trees):
            tree = trees[path]
            for node in ast.walk(tree):
                # span = "..." class attributes
                if isinstance(node, ast.Assign) and phases is not None:
                    for t in node.targets:
                        if isinstance(t, ast.Name) and t.id == "span" \
                                and isinstance(node.value, ast.Constant) \
                                and isinstance(node.value.value, str) \
                                and node.value.value not in phases:
                            findings.append(Finding(
                                "APX804", path, node.lineno,
                                f"span attribute "
                                f"'{node.value.value}' is not in "
                                f"observe.PHASES {sorted(phases)} — "
                                "declare the phase or rename the "
                                "span"))
                if not isinstance(node, ast.Call):
                    continue
                cn = call_name(node)
                if cn in ("begin", "end", "instant") \
                        and isinstance(node.func, ast.Attribute) \
                        and node.args:
                    arg = node.args[0]
                    vocab = lifecycle if cn == "instant" else phases
                    vocab_name = "LIFECYCLE" if cn == "instant" \
                        else "PHASES"
                    if vocab is None:
                        continue
                    if isinstance(arg, ast.Constant) \
                            and isinstance(arg.value, str):
                        if arg.value not in vocab:
                            findings.append(Finding(
                                "APX804", path, node.lineno,
                                f"{cn}('{arg.value}') emits a name "
                                f"missing from observe."
                                f"{vocab_name} — the replay stream "
                                "and Perfetto tracks key on "
                                "declared names"))
                    elif isinstance(arg, ast.Attribute) \
                            and arg.attr == "span" and cn != "instant":
                        pass  # transfer classes' declared span attr
                    else:
                        findings.append(Finding(
                            "APX804", path, node.lineno,
                            f"dynamic name at a tracer.{cn}() emit "
                            "site — names must be literals from "
                            f"observe.{vocab_name} (or the declared "
                            "`span` attribute) so the vocabulary "
                            "can vouch for them"))
                elif cn in ("counter", "gauge", "histogram") \
                        and isinstance(node.func, ast.Attribute):
                    arg = _name_arg(node)
                    if arg is None:
                        continue
                    if isinstance(arg, ast.Constant) \
                            and isinstance(arg.value, str):
                        created.add(arg.value)
                    elif isinstance(arg, ast.JoinedStr):
                        pat = _fstring_pattern(arg)
                        if pat is None:
                            findings.append(Finding(
                                "APX804", path, node.lineno,
                                f"metric {cn}() name is an f-string "
                                "with no literal structure — "
                                "read-backs cannot be checked "
                                "against it"))
                        else:
                            families.append(pat)
                    else:
                        findings.append(Finding(
                            "APX804", path, node.lineno,
                            f"fully dynamic metric {cn}() name — "
                            "use a literal (or an f-string family "
                            "with literal structure) so read-back "
                            "sites can be verified against it"))
                elif cn in ("get", "quantiles") \
                        and isinstance(node.func, ast.Attribute) \
                        and node.args \
                        and isinstance(node.args[0], ast.Constant) \
                        and isinstance(node.args[0].value, str) \
                        and node.args[0].value.startswith("serving_"):
                    lookups.append((path, node.lineno, cn,
                                    node.args[0].value))

        for path, line, cn, name in lookups:
            if name in created:
                continue
            if any(fnmatch.fnmatchcase(name, pat) for pat in families):
                continue
            findings.append(Finding(
                "APX804", path, line,
                f"registry.{cn}('{name}') reads a metric no serving "
                "module creates — a renamed or dropped metric here "
                "returns nothing, silently"))
    return findings

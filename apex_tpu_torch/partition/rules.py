"""Regex-rule -> PartitionSpec-tree engine (counterpart of
``apex_tpu/partition/rules.py``).

One ordered table of ``(pattern, PartitionSpec)`` pairs, matched with
``re.search`` against each leaf's ``/``-joined tree path, gives the spec
tree of any parameter-shaped tree: model params, optimizer moments and
the serving KV cache derive their specs from the same table
(:mod:`apex_tpu_torch.partition.tables`).

Paths spell what the JAX package spells for the same tree: dict keys,
NamedTuple fields and sequence indices, in JAX's flatten order (dict
keys sorted; ``None`` an empty subtree), so the tables match unchanged.
Conventions, as the JAX package's:

- matching is ``re.search``, so unanchored patterns apply at any depth
  (``layers/qkv/kernel`` matches the stacked GPT leaves and the same
  leaves under an ``m/``- or ``v/``-prefixed optimizer tree);
- 0-d leaves are replicated (``P()``) without consulting the table;
- the first matching rule wins;
- a leaf no rule matches raises ``ValueError``.
"""

import re
from typing import Any, Callable, List, Sequence, Tuple

from apex_tpu_torch.transformer import parallel_state as ps
from apex_tpu_torch.utils.tree import tree_map

PartitionSpec = ps.PartitionSpec
Rule = Tuple[str, PartitionSpec]


def _key_part(k) -> str:
    for attr in ("key", "name", "idx"):
        part = getattr(k, attr, None)
        if part is not None:
            return str(part)
    return str(k)


def tree_path_name(path) -> str:
    """``/``-joined name of one key path (dict keys, NamedTuple fields
    and sequence indices in their plain string form; JAX's key objects
    are read by their ``key`` / ``name`` / ``idx``)."""
    return "/".join(_key_part(k) for k in path)


def _flatten_with_path(tree, path=()):
    """``[(path, leaf), ...]`` in JAX's flatten order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [item for k in sorted(tree)
                for item in _flatten_with_path(tree[k], path + (k,))]
    if isinstance(tree, (list, tuple)) and not isinstance(tree,
                                                          PartitionSpec):
        names = getattr(tree, "_fields", range(len(tree)))
        return [item for k, v in zip(names, tree)
                for item in _flatten_with_path(v, path + (k,))]
    return [(path, tree)]


def _map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over ``tree``, keeping its structure."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        if hasattr(tree, "_fields"):
            return type(tree)(*(_map_with_path(fn, v, path + (k,))
                                for k, v in zip(tree._fields, tree)))
        return type(tree)(_map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def tree_paths(tree: Any) -> List[str]:
    """The ``/``-joined path of every leaf, in flatten order."""
    return [tree_path_name(path) for path, _ in _flatten_with_path(tree)]


def _is_scalar(leaf) -> bool:
    return len(getattr(leaf, "shape", ())) == 0


def match_partition_rules(rules: Sequence[Rule], params: Any) -> Any:
    """Spec tree for ``params``: the first ``re.search`` match of each
    leaf's path wins; 0-d leaves are replicated; an unmatched leaf of
    higher rank raises ``ValueError``."""
    def assign(path, leaf):
        name = tree_path_name(path)
        if _is_scalar(leaf):
            return PartitionSpec()
        for pattern, spec in rules:
            if re.search(pattern, name):
                return spec
        raise ValueError(
            f"no partition rule matches leaf '{name}' "
            f"(shape {tuple(getattr(leaf, 'shape', ()))}) — every "
            "non-scalar leaf must be covered by the rule table")

    return _map_with_path(assign, params)


def rule_match_table(rules: Sequence[Rule],
                     params: Any) -> List[Tuple[str, Any, List[int]]]:
    """``(path, leaf, [indices of every rule whose pattern matches])``
    for each leaf, 0-d leaves included (they replicate whatever
    matches)."""
    out = []
    for path, leaf in _flatten_with_path(params):
        name = tree_path_name(path)
        hits = [i for i, (pattern, _) in enumerate(rules)
                if re.search(pattern, name)]
        out.append((name, leaf, hits))
    return out


def spec_axis_names(spec: PartitionSpec) -> List[str]:
    """Every mesh axis a spec names, in order, tuple entries such as
    ``(("model", "data"), None)`` flattened."""
    out: List[str] = []
    for entry in tuple(spec):
        if entry is None:
            continue
        for ax in (entry if isinstance(entry, tuple) else (entry,)):
            out.append(str(ax))
    return out


def optimizer_state_specs(rules: Sequence[Rule], params: Any,
                          families: Sequence[str] = ("m", "v", "master"),
                          ) -> dict:
    """Spec trees for params-shaped optimizer state from the same table,
    re-matched under a family prefix (``m/<param path>`` ...): an
    unanchored table gives the params' specs; a pattern anchored at the
    root stops matching the prefixed paths."""
    return {fam: match_partition_rules(rules, {fam: params})[fam]
            for fam in families}


def make_shard_and_gather_fns(partition_specs: Any, mesh=None,
                              ) -> Tuple[Any, Any]:
    """Trees of ``shard_fn(x)`` / ``gather_fn(x)`` like
    ``partition_specs``: a shard function keeps this rank's block of a
    whole value along every dimension its spec names (its index on that
    axis, ``parallel_state.shard_leaf``); a gather function all-gathers a
    block back into the whole value over each named axis's group, in
    mesh order (``parallel_state.gather_leaf``). ``mesh``: the
    installed one by default, read when a function runs."""
    def make_shard(spec) -> Callable:
        return lambda x: ps.shard_leaf(x, spec, mesh)

    def make_gather(spec) -> Callable:
        return lambda x: ps.gather_leaf(x, spec, mesh)

    is_spec = lambda x: isinstance(x, PartitionSpec)  # noqa: E731
    return (tree_map(make_shard, partition_specs, is_leaf=is_spec),
            tree_map(make_gather, partition_specs, is_leaf=is_spec))

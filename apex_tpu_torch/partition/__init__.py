"""Partition-rule engine (counterpart of ``apex_tpu/partition``): one
regex table shards everything. ``match_partition_rules`` turns an
ordered ``(pattern, PartitionSpec)`` table into the spec tree of any
parameter-shaped tree; ``gpt_rules`` / ``bert_rules`` are the default
Megatron tables; ``optimizer_state_specs`` derives the moments' specs
from the same table; ``make_shard_and_gather_fns`` gives per-leaf
placement functions; ``make_mesh`` installs the dp x tp x pp x cp mesh
through ``parallel_state``."""

from apex_tpu_torch.partition.mesh import make_mesh
from apex_tpu_torch.partition.rules import (
    make_shard_and_gather_fns,
    match_partition_rules,
    optimizer_state_specs,
    rule_match_table,
    spec_axis_names,
    tree_path_name,
    tree_paths,
)
from apex_tpu_torch.partition.tables import (
    bert_rules,
    draft_gpt_rules,
    gpt_quant_rules,
    gpt_rules,
    kv_cache_quant_rules,
    kv_cache_rules,
)

__all__ = [
    "bert_rules",
    "draft_gpt_rules",
    "gpt_quant_rules",
    "gpt_rules",
    "kv_cache_quant_rules",
    "kv_cache_rules",
    "make_mesh",
    "make_shard_and_gather_fns",
    "match_partition_rules",
    "optimizer_state_specs",
    "rule_match_table",
    "spec_axis_names",
    "tree_path_name",
    "tree_paths",
]

"""Default partition-rule tables (GPT, BERT, the serving KV cache), the
counterpart of ``apex_tpu/partition/tables.py``, as data.

One table per model family covers everything that family shards: the
parameter tree, the optimizer moments derived from it
(:func:`apex_tpu_torch.partition.rules.optimizer_state_specs`) and, for
GPT, the serving KV cache (:func:`apex_tpu_torch.serving.cache.
cache_partition_specs` matches its ``KVCache`` template against the
same rules). The tables are written so that every leaf matches one rule.

Layout (Megatron over the ``model`` mesh axis):

- vocabulary-split word embeddings ``P(model, None)``; position and
  token-type tables replicated;
- Column-parallel qkv / fc1: the output dimension split (the kernel's
  last dimension, the bias);
- Row-parallel out / fc2: the input dimension split, the bias replicated
  (added after the all-reduce);
- layer norms replicated;
- GPT's layer leaves carry a leading stacked ``num_layers`` dimension,
  hence the extra leading ``None``;
- KV cache: heads (axis 2 of ``(L, slots, heads, S, d)``) split over
  ``model``, each rank caching the heads its head-major qkv column
  block produces; slot lengths replicated.
"""

from apex_tpu_torch.transformer import parallel_state as ps

P = ps.PartitionSpec

# KV-cache rules, shared by both GPT tables: the ``KVCache`` /
# ``PagedKVCache`` fields, matched at the end of the path. The k/v rule
# covers the dense ``(L, slots, heads, S, d)`` and the paged ``(L, pages,
# heads, page, d)`` layouts (heads on axis 2 in both); block tables
# replicate, every rank walks the same mapping.
_KV_CACHE_RULES = (
    (r"(^|/)(k|v)$", P(None, None, ps.TENSOR_AXIS, None, None)),
    (r"(^|/)lengths$", P()),
    (r"(^|/)block_tables$", P()),
)


def kv_cache_rules():
    """The serving-cache slice of the default tables."""
    return _KV_CACHE_RULES


def kv_cache_quant_rules():
    """KV-cache rules for the int8 paged pool: the base rules and the
    per-page-per-head fp32 scales ``(L, pages, heads)``, heads (axis 2,
    as the pool's) split over ``model``."""
    return _KV_CACHE_RULES + (
        (r"(^|/)(k|v)_scale$", P(None, None, ps.TENSOR_AXIS)),
    )


def gpt_quant_rules():
    """Rule table for the weight-only int8 GPT tree
    (``apex_tpu_torch.quant.quantize_params``) and the int8 paged cache.
    Kernels keep their specs; each ``scale`` is its kernel's spec with
    the contracted axis dropped: Column (qkv / fc1) scales follow their
    output channels onto ``model`` like the bias, Row (out / fc2) scales
    replicate, the word table's scale rides the vocabulary split."""
    t = ps.TENSOR_AXIS
    return (
        ("embedding/word/embedding", P(t, None)),
        ("embedding/word/scale", P(t)),
        ("embedding/position/embedding", P()),
        ("layers/(ln1|ln2)/(weight|bias)", P(None)),
        ("layers/qkv/kernel", P(None, None, t)),
        ("layers/qkv/(bias|scale)", P(None, t)),
        ("layers/out/kernel", P(None, t, None)),
        ("layers/out/(bias|scale)", P(None)),
        ("layers/fc1/kernel", P(None, None, t)),
        ("layers/fc1/(bias|scale)", P(None, t)),
        ("layers/fc2/kernel", P(None, t, None)),
        ("layers/fc2/(bias|scale)", P(None)),
        ("final_ln/(weight|bias)", P()),
    ) + kv_cache_quant_rules()


def gpt_rules():
    """Rule table for the GPT param tree (``models.gpt.init_gpt``) and
    the serving KV cache. The first match wins."""
    t = ps.TENSOR_AXIS
    return (
        ("embedding/word/embedding", P(t, None)),
        ("embedding/position/embedding", P()),
        ("layers/(ln1|ln2)/(weight|bias)", P(None)),
        ("layers/qkv/kernel", P(None, None, t)),
        ("layers/qkv/bias", P(None, t)),
        ("layers/out/kernel", P(None, t, None)),
        ("layers/out/bias", P(None)),
        ("layers/fc1/kernel", P(None, None, t)),
        ("layers/fc1/bias", P(None, t)),
        ("layers/fc2/kernel", P(None, t, None)),
        ("layers/fc2/bias", P(None)),
        ("final_ln/(weight|bias)", P()),
    ) + _KV_CACHE_RULES


def draft_gpt_rules():
    """Rule table for the speculative draft model's tree and its
    lockstep cache (``serving.draft_model.DraftModel``): :func:`gpt_rules`
    without the rows no draft tree has (draft configs are RoPE-only, so
    no ``embedding/position``; the draft cache is dense, so no block
    tables)."""
    dead = ("embedding/position/embedding", r"(^|/)block_tables$")
    return tuple(rule for rule in gpt_rules() if rule[0] not in dead)


def bert_rules():
    """Rule table for the BERT param tree (``models.bert.init_bert``).
    BERT's layers are a list (paths carry ``encoder/<i>/``), so the
    patterns stay unanchored; every layer norm replicates by one rule.
    No KV-cache rules: BERT is not served incrementally."""
    t = ps.TENSOR_AXIS
    return (
        ("embeddings/word/embedding", P(t, None)),
        ("embeddings/(position|token_type)/embedding", P()),
        ("layernorm/(weight|bias)", P()),
        ("(qkv|fc1)/kernel", P(None, t)),
        ("(qkv|fc1)/bias", P(t)),
        ("(attention/out|fc2)/kernel", P(t, None)),
        ("(attention/out|fc2)/bias", P()),
        ("mlm_head/transform/(kernel|bias)", P()),
        ("mlm_head/bias", P()),
        ("pooler/(kernel|bias)", P()),
    )

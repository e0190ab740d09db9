"""Dense KV cache (counterpart of ``apex_tpu/serving/cache.py``).

Layout: ``k``/``v`` are ``(num_layers, num_slots, num_heads, S_max,
head_dim)``; ``lengths`` ``(num_slots,)`` int32 is each slot's count of
real positions — the next write offset and the attention-mask bound.
The prefill and decode steps update these tensors IN PLACE (the
counterpart of the JAX package's donated cache). bf16 halves the bytes;
fp32 is for parity tests.

The paged cache (:class:`PagedKVCache`) holds a POOL of fixed-size pages
shared by every slot plus per-slot block tables mapping logical page
indices to physical pages; the host-side allocator
(``serving.paging.PagePool``) decides placement. An int8 pool carries
per-page-per-head fp32 scales. The steps update the pool, the lengths
and the block tables in place, as the dense cache's.
"""

from typing import NamedTuple, Optional

import numpy as np
import torch

from apex_tpu_torch.models.gpt import GPTConfig
from apex_tpu_torch.utils.platform import DeviceLike, resolve_device


class KVCache(NamedTuple):
    k: torch.Tensor        # (L, num_slots, num_heads, S_max, head_dim)
    v: torch.Tensor        # (L, num_slots, num_heads, S_max, head_dim)
    lengths: torch.Tensor  # (num_slots,) int32, valid positions per slot


def init_cache(cfg: GPTConfig, num_slots: int, max_len: int,
               dtype: torch.dtype = torch.bfloat16,
               device: DeviceLike = None) -> KVCache:
    """Zero-filled cache for ``num_slots`` concurrent sequences of up to
    ``max_len`` tokens each (prompt + generated)."""
    if max_len < 1 or num_slots < 1:
        raise ValueError(
            f"need positive num_slots/max_len, got {num_slots}/{max_len}")
    if not cfg.use_rope and max_len > cfg.max_position_embeddings:
        raise ValueError(
            f"max_len {max_len} exceeds the learned position table "
            f"({cfg.max_position_embeddings}); raise "
            "max_position_embeddings or use rope")
    dev = resolve_device(device)
    shape = (cfg.num_layers, num_slots, cfg.num_heads, max_len,
             cfg.head_dim)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=dev),
                   v=torch.zeros(shape, dtype=dtype, device=dev),
                   lengths=torch.zeros((num_slots,), dtype=torch.int32,
                                       device=dev))


# ---------------------------------------------------------------------------
# paged cache: fixed page pool + per-slot block tables
# ---------------------------------------------------------------------------

# Physical page ids below this are reserved and never allocated:
NULL_PAGE = 0     # parks unmapped block-table entries; never written
SCRATCH_PAGE = 1  # write dump for redirected rows; never attended
RESERVED_PAGES = 2


class PagedKVCache(NamedTuple):
    """Paged layout: ``k``/``v`` hold a pool of pages shared by every
    slot, ``(L, num_pages, num_heads, page_size, head_dim)``, and
    ``block_tables`` ``(num_slots, max_pages)`` int32 maps each slot's
    logical page index to a physical page. An int8 pool stores
    round-to-nearest symmetric int8 with per-page-per-head fp32 scales
    in ``k_scale``/``v_scale`` (``(L, num_pages, num_heads)``,
    ``quant.kv_quantize``); bf16/fp32 pools leave both ``None``."""
    k: torch.Tensor             # (L, num_pages, num_heads, page_size, hd)
    v: torch.Tensor             # (L, num_pages, num_heads, page_size, hd)
    lengths: torch.Tensor       # (num_slots,) int32, valid positions
    block_tables: torch.Tensor  # (num_slots, max_pages) int32 page ids
    k_scale: Optional[torch.Tensor] = None  # (L, num_pages, num_heads) f32
    v_scale: Optional[torch.Tensor] = None  # (L, num_pages, num_heads) f32


def _shape_of(*shape):
    """A leaf that carries only a shape (what rule matching reads)."""
    return torch.empty(shape, device="meta")


def cache_partition_specs(rules=None) -> KVCache:
    """Tensor-parallel layout: heads (axis 2) split over the ``model``
    axis, so a rank's cache holds the heads its qkv column block
    produces; lengths replicated. Matched from the partition-rule table
    (``partition.kv_cache_rules`` by default, or any table covering the
    ``k`` / ``v`` / ``lengths`` paths)."""
    from apex_tpu_torch.partition import kv_cache_rules, match_partition_rules

    if rules is None:
        rules = kv_cache_rules()
    template = KVCache(k=_shape_of(*(1,) * 5), v=_shape_of(*(1,) * 5),
                       lengths=_shape_of(1))
    return match_partition_rules(rules, template)


def paged_cache_partition_specs(rules=None,
                                quantized: bool = False) -> PagedKVCache:
    """:func:`cache_partition_specs` for the paged pool: its head axis
    (axis 2) split over ``model``; lengths and block tables replicated
    (every rank walks the same mapping over its heads). ``quantized``
    adds the ``k_scale`` / ``v_scale`` leaves, matched against
    ``kv_cache_quant_rules()`` (heads, axis 2 of the scales, split like
    the pool's)."""
    from apex_tpu_torch.partition import (
        kv_cache_quant_rules, kv_cache_rules, match_partition_rules,
    )

    if rules is None:
        rules = kv_cache_quant_rules() if quantized else kv_cache_rules()
    template = PagedKVCache(k=_shape_of(*(1,) * 5), v=_shape_of(*(1,) * 5),
                            lengths=_shape_of(1),
                            block_tables=_shape_of(1, 1))
    if quantized:
        template = template._replace(k_scale=_shape_of(1, 1, 1),
                                     v_scale=_shape_of(1, 1, 1))
    return match_partition_rules(rules, template)


def max_pages_per_slot(max_len: int, page_size: int) -> int:
    return -(-max_len // page_size)


def init_paged_cache(cfg: GPTConfig, num_slots: int, max_len: int,
                     num_pages: int, page_size: int,
                     dtype: torch.dtype = torch.bfloat16,
                     device: DeviceLike = None) -> PagedKVCache:
    """Zero page pool + block tables parked on ``SCRATCH_PAGE`` (writes
    of unoccupied slots land in scratch, reads of it are masked). An
    int8 pool starts with zero pages and zero scales (a 0-scale page
    dequantizes to exact zeros)."""
    if max_len < 1 or num_slots < 1 or page_size < 1:
        raise ValueError(
            f"need positive num_slots/max_len/page_size, got "
            f"{num_slots}/{max_len}/{page_size}")
    if num_pages <= RESERVED_PAGES:
        raise ValueError(
            f"num_pages {num_pages} must exceed the {RESERVED_PAGES} "
            f"reserved pages (null + scratch)")
    if not cfg.use_rope and max_len > cfg.max_position_embeddings:
        raise ValueError(
            f"max_len {max_len} exceeds the learned position table "
            f"({cfg.max_position_embeddings}); raise "
            "max_position_embeddings or use rope")
    dev = resolve_device(device)
    shape = (cfg.num_layers, num_pages, cfg.num_heads, page_size,
             cfg.head_dim)
    bt = torch.full((num_slots, max_pages_per_slot(max_len, page_size)),
                    SCRATCH_PAGE, dtype=torch.int32, device=dev)
    lengths = torch.zeros((num_slots,), dtype=torch.int32, device=dev)
    if dtype == torch.int8:
        sscale = (cfg.num_layers, num_pages, cfg.num_heads)
        return PagedKVCache(
            k=torch.zeros(shape, dtype=torch.int8, device=dev),
            v=torch.zeros(shape, dtype=torch.int8, device=dev),
            lengths=lengths, block_tables=bt,
            k_scale=torch.zeros(sscale, dtype=torch.float32, device=dev),
            v_scale=torch.zeros(sscale, dtype=torch.float32, device=dev))
    return PagedKVCache(k=torch.zeros(shape, dtype=dtype, device=dev),
                        v=torch.zeros(shape, dtype=dtype, device=dev),
                        lengths=lengths, block_tables=bt)


def audit_block_tables(block_tables, slot_pages) -> bool:
    """Cross-check the device block tables against the host allocator's
    per-slot page lists: row ``i`` must map exactly ``slot_pages[i]``
    followed by a NULL/SCRATCH-parked tail. Raises
    :class:`~apex_tpu_torch.serving.health.PoolInvariantError`."""
    from apex_tpu_torch.serving.health import PoolInvariantError

    bt = block_tables.cpu().numpy() if isinstance(
        block_tables, torch.Tensor) else np.asarray(block_tables)
    if bt.shape[0] != len(slot_pages):
        raise PoolInvariantError(
            f"block table has {bt.shape[0]} rows but the host tracks "
            f"{len(slot_pages)} slots")
    for i, pages in enumerate(slot_pages):
        if len(pages) > bt.shape[1]:
            raise PoolInvariantError(
                f"slot {i}: host maps {len(pages)} pages but the table "
                f"row holds {bt.shape[1]}")
        mapped = bt[i, :len(pages)].tolist()
        if mapped != list(pages):
            raise PoolInvariantError(
                f"slot {i}: device row maps {mapped}, host allocator "
                f"says {list(pages)}")
        tail = bt[i, len(pages):]
        stray = tail[(tail != NULL_PAGE) & (tail != SCRATCH_PAGE)]
        if stray.size:
            raise PoolInvariantError(
                f"slot {i}: unmapped tail holds live page ids "
                f"{sorted(set(stray.tolist()))} (must be NULL/SCRATCH)")
    return True

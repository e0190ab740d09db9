"""Page extract and insert steps (counterpart of the device half of
``apex_tpu/serving/transfer.py``): gather whole pages out of a
``PagedKVCache``'s pool by page id, and scatter tiles back into the
pages a pool allocated. The host spill tier spills an evicted prefix
page through the extract and promotes it back through one batched
insert; the promoted page holds the spilled bytes bit for bit (an int8
pool's fp32 scale planes with them).

Tiles are ``(layers, n_pages, heads, page_size, head_dim)`` in the pool
dtype, scale planes ``(layers, n_pages, heads)`` fp32. Extract reads
(the source cache keeps serving); insert writes the pool IN PLACE, the
port's form of the JAX package's donated cache.
"""

from typing import Callable

import torch


def _ids(cache, page_ids) -> torch.Tensor:
    return torch.as_tensor(page_ids, dtype=torch.long,
                           device=cache.k.device)


def _tile(pool: torch.Tensor, x) -> torch.Tensor:
    """A host tile as ``pool``'s dtype on its device; bf16 tiles cross
    the host as 16-bit integer bits (numpy has no bf16) and are
    reinterpreted, not converted."""
    t = torch.as_tensor(x)
    if t.dtype != pool.dtype and not t.dtype.is_floating_point \
            and t.element_size() == pool.element_size():
        t = t.view(pool.dtype)
    return t.to(device=pool.device, dtype=pool.dtype)


def make_extract_pages_fn() -> Callable:
    """``(cache, page_ids) -> (k_tile, v_tile)``: the identified pages of
    every layer, gathered (copies)."""

    def extract(cache, page_ids):
        ids = _ids(cache, page_ids)
        return cache.k[:, ids], cache.v[:, ids]

    return extract


def make_insert_pages_fn() -> Callable:
    """``(cache, page_ids, k_tile, v_tile) -> cache``: scatter the tiles
    into the identified pages of every layer, in place."""

    def insert(cache, page_ids, k_tile, v_tile):
        ids = _ids(cache, page_ids)
        cache.k[:, ids] = _tile(cache.k, k_tile)
        cache.v[:, ids] = _tile(cache.v, v_tile)
        return cache

    return insert


def make_extract_pages_quant_fn() -> Callable:
    """:func:`make_extract_pages_fn` for the int8 pool: ``(cache,
    page_ids) -> (k_tile, v_tile, k_scale, v_scale)``, the fp32 scale
    planes with the tiles (a page's rows mean nothing without the scales
    they were quantized against)."""

    def extract(cache, page_ids):
        ids = _ids(cache, page_ids)
        return (cache.k[:, ids], cache.v[:, ids], cache.k_scale[:, ids],
                cache.v_scale[:, ids])

    return extract


def make_insert_pages_quant_fn() -> Callable:
    """:func:`make_insert_pages_fn` for the int8 pool: ``(cache,
    page_ids, k_tile, v_tile, k_scale, v_scale) -> cache``, tiles and
    scale planes scattered in place, so the promoted page dequantizes to
    the spilled values."""

    def insert(cache, page_ids, k_tile, v_tile, k_scale, v_scale):
        ids = _ids(cache, page_ids)
        cache.k[:, ids] = _tile(cache.k, k_tile)
        cache.v[:, ids] = _tile(cache.v, v_tile)
        cache.k_scale[:, ids] = _tile(cache.k_scale, k_scale)
        cache.v_scale[:, ids] = _tile(cache.v_scale, v_scale)
        return cache

    return insert

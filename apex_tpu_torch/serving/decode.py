"""Prefill and single-token decode over the dense KV cache (counterpart
of ``apex_tpu/serving/decode.py``), unsharded and tensor-parallel. A
weight-only int8 tree (``quant.quantize_params``) runs the same steps
with its linears, embedding lookup and tied logits head swapped for the
w8 versions.

- **prefill** runs the full forward once over one slot's bucket-padded
  prompt, writes that slot's K/V rows (pad tail zeroed) and length, and
  returns the logits at the last real token.
- **decode** advances every slot one token: writes the new K/V row at
  ``pos = lengths`` and attends with an ``s <= pos`` mask; ``active``
  gates the length advance. Its logits match a full-sequence forward at
  the same positions (the headline serving contract).

Both update the cache IN PLACE — the counterpart of the JAX package's
donated cache — and return it for the same call shape, ``(cache,
logits)``.

The paged steps run the same forwards over ``PagedKVCache``: the paged
prefill cuts each layer's k/v tiles into whole pages and scatters them
to the host's ``write_pages`` (prefix-shared pages and the pad tail go
to ``SCRATCH_PAGE``; an int8 pool quantizes each page per head) and
installs the slot's block-table row; the paged decode writes each new
row through the block table and attends with
``paged_decode_attention``. ``make_copy_page_fn`` clones one page across
all layers (copy-on-write), with its int8 scales.

- **verify** (speculative decoding) advances every slot over k1
  candidate positions at once — the pending token plus the drafts —
  and returns per-position logits (B, k1, V): all k1 K/V rows are
  written before attending (per-query ``s <= pos + j`` masks), and the
  lengths are NOT advanced; the host commits the accepted prefix
  (``DecodeEngine.commit``), so a rejected candidate's row is never
  admitted by a mask before a later step rewrites it.
- **tree verify** scores a draft tree a slot: node j writes its row at
  ``pos + j``, attends (and takes its position) at ``pos + depth[j]``
  under an ancestor matrix ``anc``.

- **chunk prefill** runs the prompt forward INCREMENTALLY, one chunk
  of ``chunk_tokens`` positions a call, write-then-attend against the
  rows earlier chunks wrote (the verify mechanics at prompt width);
  each call sets the slot's length to the chunk's end, and the final
  chunk's logits row (at the last REAL token) is the first-token
  sampling input. On the paged cache chunks are whole pages, written to
  the host's ``write_pages`` while attention gathers through the slot's
  real row (``gather_row``); the stored row stays parked on scratch
  until the final chunk. The host spill tier prefills the suffix past
  its promoted pages with the same step.

Each core takes four linears (qkv, out, fc1, fc2): the unsharded steps
pass one linear four times. The tensor-parallel steps
(``make_tp_*_fn``, the JAX package's ``jit(shard_map(...))`` builders)
run the same cores in each rank's process over ``GPTModel``'s Column /
Row / VocabParallel layers (their int8 twins with ``quantized``): heads,
and the cache's head axis, split over the ``model`` axis; the logits
leave through the vocab-parallel tied head and the rank-order gather,
the whole (b, V) row on every rank; block tables, page ids, tree
descriptors, slots, positions and masks are the same on every rank. A
step takes this rank's block of the params (``shard_tp_params``) and of
the cache (``shard_tp_cache``), cut once, and writes the cache block in
place: a call moves no weight and no cache.

The dense verify and chunk steps attend in plain PyTorch (XLA in the JAX
package). The paged verify attends through ``paged_verify_attention``,
one kernel launch a layer a slice of ``verify_slices`` on the card; the
paged chunk through ``paged_chunk_attention``, on the card one launch a
layer of the chunk kernel for a bf16 chunk over a bf16 pool (an fp32
chunk is a linear verify window of k1 = sc on the verify kernel).
"""

from typing import Any, Dict

import torch

from apex_tpu_torch.models.gpt import (
    GPTConfig, GPTModel, _block_chunk_prefill, _block_chunk_prefill_paged,
    _block_decode, _block_decode_paged,
    _block_prefill, _block_tree_verify, _block_tree_verify_paged,
    _block_verify, _block_verify_paged, _ln, _rope_or_none, _tied_lm_logits,
    _unstack, check_config,
)
from apex_tpu_torch.models.gpt import dense as _dense
from apex_tpu_torch.quant.kernels import kv_quantize, w8_matmul, w8_matmul_nk
from apex_tpu_torch.serving.cache import (
    KVCache, PagedKVCache, cache_partition_specs, paged_cache_partition_specs,
)
from apex_tpu_torch.transformer import parallel_state as ps
from apex_tpu_torch.transformer import tensor_parallel as tp


def _prefill_core(params, cfg: GPTConfig, cache: KVCache, ids, mask,
                  slot, *, embed_fn, dense_fns, logits_fn):
    """ids (1, s_bucket) already bucket-padded; mask (s_bucket,) int32
    with 1 = real token; slot: cache row. Returns (cache, logits
    (1, V) fp32)."""
    if ids.dim() != 2 or ids.shape[0] != 1:
        raise ValueError(f"prefill takes one slot's (1, s) ids, got "
                         f"{tuple(ids.shape)}")
    s = ids.shape[1]
    if s > cache.k.shape[3]:
        raise ValueError(f"prompt bucket {s} exceeds cache max_len "
                         f"{cache.k.shape[3]}")
    slot = int(slot)
    x = embed_fn(params, ids)
    freqs = _rope_or_none(cfg, s, ids.device)
    key_mask = mask[None, :]
    mz = mask.to(x.dtype)[None, None, :, None]
    for i, lp in enumerate(_unstack(params["layers"], cfg.num_layers)):
        x, k, v = _block_prefill(lp, x, cfg, freqs, key_mask, *dense_fns)
        # zero the pad tail before it enters the cache: the decode mask
        # never reaches rows past the length, and zeroed rows keep the
        # cache independent of pad ids
        cache.k[i, slot, :, :s] = (k[0] * mz[0]).to(cache.k.dtype)
        cache.v[i, slot, :, :s] = (v[0] * mz[0]).to(cache.v.dtype)
    hidden = _ln(params["final_ln"], x, cfg.layer_norm_eps)
    length = mask.sum().to(torch.int32)
    h_last = hidden.index_select(1, (length - 1).reshape(1).long())[:, 0]
    cache.lengths[slot] = length
    return cache, logits_fn(params, h_last)


def _decode_core(params, cfg: GPTConfig, cache: KVCache, tokens, active,
                 *, embed_fn, dense_fns, logits_fn):
    """tokens (B,) — each slot's previous token; active (B,) bool gates
    the length advance. Returns (cache, logits (B, V) fp32)."""
    pos = cache.lengths.clone()
    x = embed_fn(params, tokens[:, None], pos=pos)
    freqs = _rope_or_none(cfg, cache.k.shape[3], tokens.device)
    for i, lp in enumerate(_unstack(params["layers"], cfg.num_layers)):
        x = _block_decode(lp, x, cache.k[i], cache.v[i], pos, cfg, freqs,
                          *dense_fns)
    hidden = _ln(params["final_ln"], x, cfg.layer_norm_eps)
    logits = logits_fn(params, hidden[:, 0])
    cache.lengths.copy_(torch.where(active, pos + 1, pos))
    return cache, logits


def _paged_prefill_core(params, cfg: GPTConfig, cache: PagedKVCache, ids,
                        mask, slot, write_pages, table_row, *, embed_fn,
                        dense_fns, logits_fn):
    """Bucketed prefill into the page pool: the forward of
    :func:`_prefill_core`; each layer's k/v tiles (pad tail zeroed) are
    cut into whole pages and scattered to ``write_pages`` (one physical
    page per bucket page, the host's redirects to ``SCRATCH_PAGE``
    included), and ``table_row`` ((max_pages,) int32, NULL-padded)
    becomes the slot's block-table row. An int8 pool quantizes each page
    per head (``kv_quantize``) and stores tiles and scales together."""
    if ids.dim() != 2 or ids.shape[0] != 1:
        raise ValueError(f"prefill takes one slot's (1, s) ids, got "
                         f"{tuple(ids.shape)}")
    s = ids.shape[1]
    page_size = cache.k.shape[3]
    if s % page_size:
        raise ValueError(f"prompt bucket {s} is not a multiple of "
                         f"page_size {page_size}")
    n_bucket_pages = s // page_size
    if tuple(write_pages.shape) != (n_bucket_pages,):
        raise ValueError(f"write_pages {tuple(write_pages.shape)} != one "
                         f"page per bucket page ({n_bucket_pages},)")
    if tuple(table_row.shape) != (cache.block_tables.shape[1],):
        raise ValueError(f"table_row {tuple(table_row.shape)} != "
                         f"block-table row "
                         f"({cache.block_tables.shape[1]},)")
    slot = int(slot)
    write = write_pages.long()
    x = embed_fn(params, ids)
    freqs = _rope_or_none(cfg, s, ids.device)
    key_mask = mask[None, :]
    mz = mask.to(x.dtype)[None, :, None]

    def tiles(t):
        # (1, nh, s, hd) -> (n_bucket_pages, nh, page_size, hd), the
        # zeroed pad tail included (scratch eats it)
        nh, hd = t.shape[1], t.shape[3]
        t = (t[0] * mz).reshape(nh, n_bucket_pages, page_size, hd)
        return t.transpose(0, 1)

    for i, lp in enumerate(_unstack(params["layers"], cfg.num_layers)):
        x, k, v = _block_prefill(lp, x, cfg, freqs, key_mask, *dense_fns)
        if cache.k_scale is not None:
            kq, ks = kv_quantize(tiles(k))
            vq, vs = kv_quantize(tiles(v))
            cache.k[i, write] = kq
            cache.v[i, write] = vq
            cache.k_scale[i, write] = ks
            cache.v_scale[i, write] = vs
        else:
            cache.k[i, write] = tiles(k).to(cache.k.dtype)
            cache.v[i, write] = tiles(v).to(cache.v.dtype)
    hidden = _ln(params["final_ln"], x, cfg.layer_norm_eps)
    length = mask.sum().to(torch.int32)
    h_last = hidden.index_select(1, (length - 1).reshape(1).long())[:, 0]
    cache.lengths[slot] = length
    cache.block_tables[slot] = table_row.to(torch.int32)
    return cache, logits_fn(params, h_last)


def _paged_decode_core(params, cfg: GPTConfig, cache: PagedKVCache,
                       tokens, active, *, embed_fn, dense_fns, logits_fn):
    """One token for every slot against the page pool; the host has made
    every slot's write target exclusive (page-boundary allocation and
    copy-on-write in ``PagedDecodeEngine.prepare_decode``) before this
    runs."""
    pos = cache.lengths.clone()
    bt = cache.block_tables
    x = embed_fn(params, tokens[:, None], pos=pos)
    freqs = _rope_or_none(cfg, bt.shape[1] * cache.k.shape[3],
                          tokens.device)
    quant = cache.k_scale is not None
    for i, lp in enumerate(_unstack(params["layers"], cfg.num_layers)):
        x = _block_decode_paged(lp, x, cache.k[i], cache.v[i], bt, pos, cfg,
                                freqs, *dense_fns,
                                cache.k_scale[i] if quant else None,
                                cache.v_scale[i] if quant else None)
    hidden = _ln(params["final_ln"], x, cfg.layer_norm_eps)
    logits = logits_fn(params, hidden[:, 0])
    cache.lengths.copy_(torch.where(active, pos + 1, pos))
    return cache, logits


def _verify_core(params, cfg: GPTConfig, cache: KVCache, tokens, *,
                 embed_fn, dense_fns, logits_fn):
    """Speculative verify over the dense cache: tokens (B, k1) — column 0
    each slot's pending token, columns 1.. its drafts; row j sits at
    ``lengths + j``. Returns (cache, logits (B, k1, V) fp32); lengths are
    not advanced. The caller keeps ``lengths + k1 <= S_max``."""
    pos = cache.lengths.clone()
    x = embed_fn(params, tokens, pos=pos)
    freqs = _rope_or_none(cfg, cache.k.shape[3], tokens.device)
    for i, lp in enumerate(_unstack(params["layers"], cfg.num_layers)):
        x = _block_verify(lp, x, cache.k[i], cache.v[i], pos, cfg, freqs,
                          *dense_fns)
    hidden = _ln(params["final_ln"], x, cfg.layer_norm_eps)
    return cache, logits_fn(params, hidden)


def _tree_verify_core(params, cfg: GPTConfig, cache: KVCache, tokens,
                      depth, anc, *, embed_fn, dense_fns, logits_fn):
    """Tree verify over the dense cache: tokens (B, k1) in topological
    order (column 0 the pending token), depth (B, k1) node depths, anc
    (B, k1, k1) bool ancestor-or-self matrix. Node j's position is
    ``lengths + depth[j]``; logits row j is the teacher-forced
    distribution after j's root-to-node path. Lengths are not
    advanced."""
    pos = cache.lengths.clone()
    x = embed_fn(params, tokens, pos=pos[:, None].long() + depth.long())
    freqs = _rope_or_none(cfg, cache.k.shape[3], tokens.device)
    for i, lp in enumerate(_unstack(params["layers"], cfg.num_layers)):
        x = _block_tree_verify(lp, x, cache.k[i], cache.v[i], pos, depth,
                               anc, cfg, freqs, *dense_fns)
    hidden = _ln(params["final_ln"], x, cfg.layer_norm_eps)
    return cache, logits_fn(params, hidden)


def _paged_verify_core(params, cfg: GPTConfig, cache: PagedKVCache,
                       tokens, *, embed_fn, dense_fns, logits_fn):
    """:func:`_verify_core` over the page pool; the host has made every
    page the k1 positions touch exclusive
    (``prepare_decode(..., n_new=k1)``). An int8 pool writes by the
    whole-page requant (column 0 may rescale its page, the drafts keep
    the scale)."""
    pos = cache.lengths.clone()
    bt = cache.block_tables
    x = embed_fn(params, tokens, pos=pos)
    freqs = _rope_or_none(cfg, bt.shape[1] * cache.k.shape[3],
                          tokens.device)
    quant = cache.k_scale is not None
    for i, lp in enumerate(_unstack(params["layers"], cfg.num_layers)):
        x = _block_verify_paged(lp, x, cache.k[i], cache.v[i], bt, pos, cfg,
                                freqs, *dense_fns,
                                cache.k_scale[i] if quant else None,
                                cache.v_scale[i] if quant else None)
    hidden = _ln(params["final_ln"], x, cfg.layer_norm_eps)
    return cache, logits_fn(params, hidden)


def _paged_tree_verify_core(params, cfg: GPTConfig, cache: PagedKVCache,
                            tokens, depth, anc, *, embed_fn, dense_fns,
                            logits_fn):
    """:func:`_tree_verify_core` over the page pool (the exclusivity
    precondition of :func:`_paged_verify_core`). Refused for the int8
    pool: a non-leftmost branch commit would re-round quantized history
    at branch-dependent scales."""
    if cache.k_scale is not None:
        raise ValueError("tree verify is not offered over the int8 page "
                         "pool (kv8 keeps linear speculation)")
    pos = cache.lengths.clone()
    bt = cache.block_tables
    x = embed_fn(params, tokens, pos=pos[:, None].long() + depth.long())
    freqs = _rope_or_none(cfg, bt.shape[1] * cache.k.shape[3],
                          tokens.device)
    for i, lp in enumerate(_unstack(params["layers"], cfg.num_layers)):
        x = _block_tree_verify_paged(lp, x, cache.k[i], cache.v[i], bt, pos,
                                     depth, anc, cfg, freqs, *dense_fns)
    hidden = _ln(params["final_ln"], x, cfg.layer_norm_eps)
    return cache, logits_fn(params, hidden)


def _chunk_prefill_core(params, cfg: GPTConfig, cache: KVCache, ids, mask,
                        slot, pos, *, embed_fn, dense_fns, logits_fn):
    """One prompt chunk of one slot into the dense cache: ids (1, sc)
    bucket-padded, mask (sc,) 1 = real token (all ones but on the final
    chunk), ``slot`` the cache row and ``pos`` the chunk's first
    position. Runs the verify-style write-then-attend forward over the
    chunk, sets the slot's length to ``pos + sum(mask)`` (the prompt's
    length after the final chunk) and returns (cache, logits (1, V)) at
    the chunk's last REAL token — only the final chunk's row feeds a
    sample."""
    if ids.dim() != 2 or ids.shape[0] != 1:
        raise ValueError(f"chunk prefill takes one slot's (1, sc) ids, "
                         f"got {tuple(ids.shape)}")
    sc = ids.shape[1]
    if sc > cache.k.shape[3]:
        raise ValueError(f"chunk bucket {sc} exceeds cache max_len "
                         f"{cache.k.shape[3]}")
    slot = int(slot)
    pos = torch.as_tensor(pos, dtype=torch.int32, device=ids.device)
    x = embed_fn(params, ids, pos=pos.reshape(1))
    freqs = _rope_or_none(cfg, cache.k.shape[3], ids.device)
    key_mask = mask[None, :]
    for i, lp in enumerate(_unstack(params["layers"], cfg.num_layers)):
        x = _block_chunk_prefill(lp, x, cache.k[i], cache.v[i], slot, pos,
                                 cfg, freqs, key_mask, *dense_fns)
    hidden = _ln(params["final_ln"], x, cfg.layer_norm_eps)
    n_real = mask.sum().to(torch.int32)
    h_last = hidden.index_select(1, (n_real - 1).reshape(1).long())[:, 0]
    cache.lengths[slot] = pos + n_real
    return cache, logits_fn(params, h_last)


def _paged_chunk_prefill_core(params, cfg: GPTConfig,
                              cache: PagedKVCache, ids, mask, slot, pos,
                              write_pages, gather_row, store_row, *,
                              embed_fn, dense_fns, logits_fn):
    """One page-aligned prompt chunk of one slot into the page pool:
    ids (1, sc) bucket-padded, mask (sc,) 1 = real token, ``pos`` the
    chunk's first position. The chunk's rows are written to
    ``write_pages`` and attend through ``gather_row``; ``store_row``
    becomes the slot's block-table row and its length ``pos +
    sum(mask)``. Returns (cache, logits (1, V)) at the last real token.
    Refused for the int8 pool, as in the JAX package."""
    if cache.k_scale is not None:
        raise ValueError("chunked prefill is not offered over the int8 "
                         "page pool (kv8 keeps monolithic prefill)")
    if ids.dim() != 2 or ids.shape[0] != 1:
        raise ValueError(f"chunk prefill takes one slot's (1, sc) ids, "
                         f"got {tuple(ids.shape)}")
    sc = ids.shape[1]
    page_size = cache.k.shape[3]
    if sc % page_size:
        raise ValueError(f"chunk bucket {sc} is not a multiple of "
                         f"page_size {page_size}")
    if tuple(write_pages.shape) != (sc // page_size,):
        raise ValueError(f"write_pages {tuple(write_pages.shape)} != one "
                         f"page per chunk page ({sc // page_size},)")
    max_pages = cache.block_tables.shape[1]
    for name, row in (("gather_row", gather_row),
                      ("store_row", store_row)):
        if tuple(row.shape) != (max_pages,):
            raise ValueError(f"{name} {tuple(row.shape)} != block-table "
                             f"row ({max_pages},)")
    slot = int(slot)
    pos = torch.as_tensor(pos, dtype=torch.int32, device=ids.device)
    x = embed_fn(params, ids, pos=pos.reshape(1))
    freqs = _rope_or_none(cfg, max_pages * page_size, ids.device)
    key_mask = mask[None, :]
    for i, lp in enumerate(_unstack(params["layers"], cfg.num_layers)):
        x = _block_chunk_prefill_paged(lp, x, cache.k[i], cache.v[i],
                                       write_pages, gather_row, pos, cfg,
                                       freqs, key_mask, *dense_fns)
    hidden = _ln(params["final_ln"], x, cfg.layer_norm_eps)
    n_real = mask.sum().to(torch.int32)
    h_last = hidden.index_select(1, (n_real - 1).reshape(1).long())[:, 0]
    cache.lengths[slot] = pos + n_real
    cache.block_tables[slot] = store_row.to(torch.int32)
    return cache, logits_fn(params, h_last)


def _add_positions(cfg, params, x, ids, pos):
    """Learned positions (none under RoPE, which rotates q and k in the
    blocks instead)."""
    if cfg.use_rope:
        return x
    ptab = params["embedding"]["position"]["embedding"]
    if pos is None:
        return x + ptab[: ids.shape[1]].to(x.dtype)[None]
    # decode and verify: slot b's s tokens sit at pos[b], pos[b] + 1,
    # ...; tree verify passes explicit (b, s) positions
    if pos.dim() == 2:
        idx = pos.long()
    else:
        idx = pos[:, None].long() + torch.arange(
            ids.shape[1], device=ids.device)[None, :]
    # jnp.take's "fill", as the JAX engine reads the table: a position
    # past it (a free slot's stale length under a wide verify window)
    # reads NaN, and that slot's rows are never committed
    n = ptab.shape[0]
    rows = ptab[idx.clamp(0, n - 1)].to(x.dtype)
    inside = ((idx >= 0) & (idx < n))[..., None]
    return x + torch.where(inside, rows, torch.full(
        (), float("nan"), dtype=x.dtype, device=x.device))


def _embed_unsharded(cfg: GPTConfig, compute_dtype):
    def embed(params, ids, pos=None):
        x = params["embedding"]["word"]["embedding"][ids]
        if compute_dtype is not None:
            x = x.to(compute_dtype)
        return _add_positions(cfg, params, x, ids, pos)
    return embed


def _logits_unsharded(params, hidden):
    table = params["embedding"]["word"]["embedding"]
    return torch.matmul(hidden, table.to(hidden.dtype).t()).float()


def _dense_w8(p, x):
    """Weight-only int8 linear: the dequant-fused matmul against the
    layer's int8 kernel and per-output-channel fp32 scale."""
    return w8_matmul(x, p["kernel"], p["scale"], p["bias"],
                     out_dtype=x.dtype)


def _embed_w8(cfg: GPTConfig, compute_dtype):
    """Embedding lookup from the int8 word table: take rows, dequantize
    each against its per-row (per-vocab-entry) scale. An int8 table
    carries no activation dtype: ``compute_dtype`` gives it (fp32 with
    None, as in the JAX package)."""

    def embed(params, ids, pos=None):
        word = params["embedding"]["word"]
        x = word["embedding"][ids].float() * word["scale"][ids][..., None]
        x = x.to(torch.float32 if compute_dtype is None else compute_dtype)
        return _add_positions(cfg, params, x, ids, pos)

    return embed


def _logits_w8(params, hidden):
    """Tied logits head against the output-channel-major int8 word
    table: ``w8_matmul_nk`` contracts without transposing it."""
    word = params["embedding"]["word"]
    return w8_matmul_nk(hidden, word["embedding"], word["scale"])


def _unsharded_fns(cfg: GPTConfig, compute_dtype, quantized: bool):
    """(embed, the four linears (qkv, out, fc1, fc2), logits) of the
    unsharded steps: one linear four times."""
    if quantized:
        return (_embed_w8(cfg, compute_dtype), (_dense_w8,) * 4,
                _logits_w8)
    return (_embed_unsharded(cfg, compute_dtype), (_dense,) * 4,
            _logits_unsharded)


def _step(cfg: GPTConfig, core, fns, pool=None):
    """``step(params, cache, *args)``: ``core`` with its (embed, the four
    linears, logits) ``fns``; ``pool`` (an int8 pool expected or not)
    checks the pool's kind first."""
    embed, dense_fns, logits_fn = fns

    def step(params, cache, *args):
        if pool is not None:
            _check_pool(cache, pool)
        return core(params, cfg, cache, *args, embed_fn=embed,
                    dense_fns=dense_fns, logits_fn=logits_fn)

    return step


def make_prefill_fn(cfg: GPTConfig, compute_dtype=None,
                    quantized: bool = False):
    """``prefill(params, cache, ids, mask, slot) -> (cache, logits)``;
    the cache is updated in place. Call through a bucketing layer (the
    scheduler does) so prompts arrive at a few shapes. ``quantized``
    expects the weight-only int8 tree of ``quant.quantize_params``."""
    check_config(cfg)
    return _step(cfg, _prefill_core,
                 _unsharded_fns(cfg, compute_dtype, quantized))


def make_decode_fn(cfg: GPTConfig, compute_dtype=None,
                   quantized: bool = False):
    """``decode(params, cache, tokens, active) -> (cache, logits)``; the
    cache is updated in place and every slot advances together."""
    check_config(cfg)
    return _step(cfg, _decode_core,
                 _unsharded_fns(cfg, compute_dtype, quantized))


def make_paged_prefill_fn(cfg: GPTConfig, compute_dtype=None,
                          quantized=False):
    """``prefill(params, cache, ids, mask, slot, write_pages, table_row)
    -> (cache, logits)`` over the page pool, updated in place."""
    check_config(cfg)
    return _step(cfg, _paged_prefill_core,
                 _unsharded_fns(cfg, compute_dtype, quantized))


def make_paged_decode_fn(cfg: GPTConfig, compute_dtype=None,
                         quantized=False):
    """``decode(params, cache, tokens, active) -> (cache, logits)`` over
    the page pool, updated in place."""
    check_config(cfg)
    return _step(cfg, _paged_decode_core,
                 _unsharded_fns(cfg, compute_dtype, quantized))


def make_verify_fn(cfg: GPTConfig, compute_dtype=None, quantized=False):
    """``verify(params, cache, tokens) -> (cache, logits (B, k1, V))``
    over the dense cache, updated in place; lengths are not advanced."""
    check_config(cfg)
    return _step(cfg, _verify_core,
                 _unsharded_fns(cfg, compute_dtype, quantized))


def make_paged_verify_fn(cfg: GPTConfig, compute_dtype=None,
                         quantized=False):
    """``verify(params, cache, tokens) -> (cache, logits (B, k1, V))``
    over the page pool, updated in place."""
    check_config(cfg)
    return _step(cfg, _paged_verify_core,
                 _unsharded_fns(cfg, compute_dtype, quantized))


def make_tree_verify_fn(cfg: GPTConfig, compute_dtype=None,
                        quantized=False):
    """``verify(params, cache, tokens, depth, anc) -> (cache, logits
    (B, k1, V))`` over the dense cache (see :func:`_tree_verify_core`)."""
    check_config(cfg)
    return _step(cfg, _tree_verify_core,
                 _unsharded_fns(cfg, compute_dtype, quantized))


def make_paged_tree_verify_fn(cfg: GPTConfig, compute_dtype=None,
                              quantized=False):
    """``verify(params, cache, tokens, depth, anc) -> (cache, logits)``
    over the page pool; an int8 pool raises the reference's
    ``ValueError``."""
    check_config(cfg)
    return _step(cfg, _paged_tree_verify_core,
                 _unsharded_fns(cfg, compute_dtype, quantized))


def make_chunk_prefill_fn(cfg: GPTConfig, compute_dtype=None,
                          quantized=False):
    """``chunk_prefill(params, cache, ids, mask, slot, pos) -> (cache,
    logits)`` over the dense cache, updated in place (see
    :func:`_chunk_prefill_core`); the scheduler pads every chunk to one
    ``chunk_tokens`` bucket."""
    check_config(cfg)
    return _step(cfg, _chunk_prefill_core,
                 _unsharded_fns(cfg, compute_dtype, quantized))


def make_paged_chunk_prefill_fn(cfg: GPTConfig, compute_dtype=None,
                                quantized=False):
    """``chunk_prefill(params, cache, ids, mask, slot, pos, write_pages,
    gather_row, store_row) -> (cache, logits)`` over the page pool,
    updated in place (see :func:`_paged_chunk_prefill_core`)."""
    check_config(cfg)
    return _step(cfg, _paged_chunk_prefill_core,
                 _unsharded_fns(cfg, compute_dtype, quantized))


def make_copy_page_fn():
    """``copy(cache, src, dst) -> cache``: clone physical page ``src``
    into ``dst`` across all layers, in place — the device half of
    copy-on-write (the host picks the pages, ``PagePool.needs_copy``).
    An int8 pool clones the page's scales with its tiles, so the copy
    dequantizes to the same values."""

    def copy(cache, src, dst):
        src, dst = int(src), int(dst)
        cache.k[:, dst] = cache.k[:, src]
        cache.v[:, dst] = cache.v[:, src]
        if cache.k_scale is not None:
            cache.k_scale[:, dst] = cache.k_scale[:, src]
            cache.v_scale[:, dst] = cache.v_scale[:, src]
        return cache

    return copy


# ---------------------------------------------------------------------------
# tensor-parallel builders: heads (and the cache's head axis) over ``model``
# ---------------------------------------------------------------------------

def _tp_fns(model: GPTModel):
    """(embed, the four linears, logits) of the tensor-parallel steps:
    the vocab-parallel lookup, the Column / Row layers' ``apply``, and
    the tied head over this rank's vocabulary block followed by the
    rank-order gather, so every rank returns the whole (b, V) row (the
    serving head samples from it, where training's vocab-parallel cross
    entropy keeps the logits split)."""
    cfg = model.cfg

    def embed(params, ids, pos=None):
        x = model.embed.apply(params["embedding"]["word"], ids)
        return _add_positions(cfg, params, x, ids, pos)

    def logits(params, hidden):
        local = _tied_lm_logits(hidden,
                                params["embedding"]["word"]["embedding"])
        return tp.gather_from_tensor_model_parallel_region(local)

    dense_fns = (model.qkv.apply, model.out.apply, model.fc1.apply,
                 model.fc2.apply)
    return embed, dense_fns, logits


def _tp_quant_fns(model: GPTModel):
    """Int8 twins of :func:`_tp_fns`, the same collectives around the
    dequant-fused products: Column copies in and multiplies with its
    local bias; Row multiplies with no bias (``w8_matmul`` without one
    launches the no-bias kernel), all-reduces, then adds the replicated
    bias once (on every rank before the reduction it would count tp
    times); the lookup dequantizes this rank's rows, zeroes the rows
    outside its vocabulary block and all-reduces (fp32 activations, as
    in the JAX package); the logits are ``w8_matmul_nk`` over the local
    vocabulary block, then the gather. The int8 tree shards like the
    float one (``quant_partition_specs``: each scale with its output
    channel), so each rank's product pairs its kernel block with its
    scale block."""
    cfg = model.cfg

    def embed(params, ids, pos=None):
        word = params["embedding"]["word"]
        table = word["embedding"]            # this rank's (V/p, h) int8
        per_rank = table.shape[0]
        start = ps.get_tensor_model_parallel_rank() * per_rank
        local = ids - start
        in_range = (local >= 0) & (local < per_rank)
        safe = torch.where(in_range, local, torch.zeros_like(local))
        out = table[safe].float() * word["scale"][safe][..., None]
        out = torch.where(in_range[..., None], out,
                          torch.zeros((), device=out.device))
        x = tp.reduce_from_tensor_model_parallel_region(out)
        return _add_positions(cfg, params, x, ids, pos)

    def column(p, x):
        x = tp.copy_to_tensor_model_parallel_region(x)
        return w8_matmul(x, p["kernel"], p["scale"], p["bias"],
                         out_dtype=x.dtype)

    def row(p, x):
        y = w8_matmul(x, p["kernel"], p["scale"], out_dtype=x.dtype)
        y = tp.reduce_from_tensor_model_parallel_region(y)
        return y + p["bias"].to(y.dtype)

    def logits(params, hidden):
        word = params["embedding"]["word"]
        hidden = tp.copy_to_tensor_model_parallel_region(hidden)
        local = w8_matmul_nk(hidden, word["embedding"], word["scale"])
        return tp.gather_from_tensor_model_parallel_region(local)

    return embed, (column, row, column, row), logits


def shard_tp_params(params: Dict[str, Any], model: GPTModel,
                    quantized: bool = False, mesh=None) -> Dict[str, Any]:
    """This rank's block of the whole ``params``: what the
    tensor-parallel steps take, cut once under ``model.partition_specs()``
    (``quant_partition_specs`` for the weight-only int8 tree) by
    ``parallel_state.shard_leaf`` (a contiguous copy of each split leaf,
    a replicated leaf itself)."""
    from apex_tpu_torch.partition import make_shard_and_gather_fns
    from apex_tpu_torch.quant.params import quant_partition_specs
    from apex_tpu_torch.utils.tree import tree_map

    specs = (quant_partition_specs(model.cfg) if quantized
             else model.partition_specs())
    shard_fns, _ = make_shard_and_gather_fns(specs, mesh)
    return tree_map(lambda f, x: f(x), shard_fns, params)


def _cache_specs(cache):
    if isinstance(cache, PagedKVCache):
        return paged_cache_partition_specs(
            quantized=cache.k_scale is not None)
    return cache_partition_specs()


def _map_cache(fn, cache):
    specs = _cache_specs(cache)
    return type(cache)(*(None if t is None else fn(t, spec)
                         for t, spec in zip(cache, specs)))


def shard_tp_cache(cache, mesh=None):
    """This rank's head block of a whole ``KVCache`` or
    ``PagedKVCache`` (an int8 pool's scales with it): the pool's head
    axis split over ``model``, lengths and block tables replicated
    (``cache_partition_specs``, ``paged_cache_partition_specs``). Cut
    once; the steps then write the block in place."""
    return _map_cache(lambda t, spec: ps.shard_leaf(t, spec, mesh), cache)


def gather_tp_cache(cache, mesh=None):
    """The whole cache from each rank's head block: the head axis
    all-gathered over ``model`` in rank order (the replicated leaves as
    they are)."""
    return _map_cache(lambda t, spec: ps.gather_leaf(t, spec, mesh), cache)


def _check_pool(cache, kv_quantized: bool) -> None:
    if (cache.k_scale is not None) != bool(kv_quantized):
        raise ValueError(f"kv_quantized={kv_quantized} but the pool is "
                         f"{cache.k.dtype}")


def _tp_step(model: GPTModel, mesh, quantized: bool, core, pool=None):
    """A tensor-parallel step over ``core`` on this rank's blocks (the
    params cut by :func:`shard_tp_params`), with ``mesh`` installed
    while it runs: its collectives and ranks are that mesh's (None: the
    installed one)."""
    check_config(model.cfg)
    step = _step(model.cfg, core, _tp_quant_fns(model) if quantized
                 else _tp_fns(model), pool)
    if mesh is None:
        return step

    def run(*args):
        with ps.use_mesh(mesh):
            return step(*args)

    return run


def make_tp_prefill_fn(model: GPTModel, mesh=None, quantized=False):
    """``prefill(params, cache, ids, mask, slot) -> (cache, logits)`` on
    this rank: ``params`` its block (:func:`shard_tp_params`), ``cache``
    its head block (:func:`shard_tp_cache`), written in place; the
    logits (1, V) whole on every rank. Inputs other than the params and
    the cache are the same on every rank."""
    return _tp_step(model, mesh, quantized, _prefill_core)


def make_tp_decode_fn(model: GPTModel, mesh=None, quantized=False):
    """``decode(params, cache, tokens, active) -> (cache, logits (B,
    V))`` on this rank's blocks (see :func:`make_tp_prefill_fn`)."""
    return _tp_step(model, mesh, quantized, _decode_core)


def make_tp_verify_fn(model: GPTModel, mesh=None, quantized=False):
    """``verify(params, cache, tokens) -> (cache, logits (B, k1, V))``
    on this rank's blocks; the logits leave through the vocab-parallel
    head and the gather, as decode's."""
    return _tp_step(model, mesh, quantized, _verify_core)


def make_tp_paged_prefill_fn(model: GPTModel, mesh=None, quantized=False,
                             kv_quantized=False):
    """``prefill(params, cache, ids, mask, slot, write_pages, table_row)
    -> (cache, logits)`` over this rank's head block of the page pool:
    page ids and the table row are the same on every rank, so every
    rank writes its heads' tiles to the same physical pages.
    ``kv_quantized`` names an int8 pool (its scales split over heads
    with it); a pool of the other kind raises."""
    return _tp_step(model, mesh, quantized, _paged_prefill_core,
                    pool=kv_quantized)


def make_tp_paged_decode_fn(model: GPTModel, mesh=None, quantized=False,
                            kv_quantized=False):
    """``decode(params, cache, tokens, active) -> (cache, logits)`` over
    this rank's head block of the page pool (int8 pools too)."""
    return _tp_step(model, mesh, quantized, _paged_decode_core,
                    pool=kv_quantized)


def make_tp_paged_verify_fn(model: GPTModel, mesh=None, quantized=False,
                            kv_quantized=False):
    """``verify(params, cache, tokens) -> (cache, logits (B, k1, V))``
    over this rank's head block of the page pool (int8 pools too)."""
    return _tp_step(model, mesh, quantized, _paged_verify_core,
                    pool=kv_quantized)


def make_tp_tree_verify_fn(model: GPTModel, mesh=None, quantized=False):
    """``verify(params, cache, tokens, depth, anc) -> (cache, logits)``
    on this rank's blocks: the tree descriptors are the same on every
    rank, as block tables are."""
    return _tp_step(model, mesh, quantized, _tree_verify_core)


def make_tp_chunk_prefill_fn(model: GPTModel, mesh=None, quantized=False):
    """``chunk_prefill(params, cache, ids, mask, slot, pos) -> (cache,
    logits)`` on this rank's blocks; the final chunk's (1, V) logits
    whole on every rank."""
    return _tp_step(model, mesh, quantized, _chunk_prefill_core)


def make_tp_paged_chunk_prefill_fn(model: GPTModel, mesh=None,
                                   quantized=False):
    """``chunk_prefill(params, cache, ids, mask, slot, pos, write_pages,
    gather_row, store_row) -> (cache, logits)`` over this rank's head
    block of the page pool (an int8 pool raises, as the unsharded
    step's)."""
    return _tp_step(model, mesh, quantized, _paged_chunk_prefill_core)


def make_tp_paged_tree_verify_fn(model: GPTModel, mesh=None,
                                 quantized=False):
    """``verify(params, cache, tokens, depth, anc) -> (cache, logits)``
    over this rank's head block of the page pool (an int8 pool raises,
    as the unsharded step's)."""
    return _tp_step(model, mesh, quantized, _paged_tree_verify_core)

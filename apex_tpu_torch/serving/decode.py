"""Prefill and single-token decode over the dense KV cache (counterpart
of ``apex_tpu/serving/decode.py``; dense, unsharded). A weight-only int8
tree (``quant.quantize_params``) runs the same steps with its linears,
embedding lookup and tied logits head swapped for the w8 versions.

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

The dense verify steps attend in plain PyTorch (XLA in the JAX package);
the paged ones through ``paged_verify_attention``, one kernel launch a
layer on the card. The paged prompt-chunk step
(``make_paged_chunk_prefill_fn``) runs the verify mechanics over one
slot's page-aligned prompt chunk; the host spill tier prefills the
suffix past its promoted pages with it.
"""

import torch

from apex_tpu_torch.models.gpt import (
    GPTConfig, _block_chunk_prefill_paged, _block_decode, _block_decode_paged,
    _block_prefill, _block_tree_verify, _block_tree_verify_paged,
    _block_verify, _block_verify_paged, _ln, _rope_or_none, _unstack,
    check_config,
)
from apex_tpu_torch.models.gpt import dense as _dense
from apex_tpu_torch.quant.kernels import kv_quantize, w8_matmul, w8_matmul_nk
from apex_tpu_torch.serving.cache import KVCache, PagedKVCache


def _prefill_core(params, cfg: GPTConfig, cache: KVCache, ids, mask,
                  slot, *, embed_fn, dense_fn, logits_fn):
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
        x, k, v = _block_prefill(lp, x, cfg, freqs, key_mask, dense_fn)
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
                 *, embed_fn, dense_fn, logits_fn):
    """tokens (B,) — each slot's previous token; active (B,) bool gates
    the length advance. Returns (cache, logits (B, V) fp32)."""
    pos = cache.lengths.clone()
    x = embed_fn(params, tokens[:, None], pos=pos)
    freqs = _rope_or_none(cfg, cache.k.shape[3], tokens.device)
    for i, lp in enumerate(_unstack(params["layers"], cfg.num_layers)):
        x = _block_decode(lp, x, cache.k[i], cache.v[i], pos, cfg, freqs,
                          dense_fn)
    hidden = _ln(params["final_ln"], x, cfg.layer_norm_eps)
    logits = logits_fn(params, hidden[:, 0])
    cache.lengths.copy_(torch.where(active, pos + 1, pos))
    return cache, logits


def _paged_prefill_core(params, cfg: GPTConfig, cache: PagedKVCache, ids,
                        mask, slot, write_pages, table_row, *, embed_fn,
                        dense_fn, logits_fn):
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
        x, k, v = _block_prefill(lp, x, cfg, freqs, key_mask, dense_fn)
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
                       tokens, active, *, embed_fn, dense_fn, logits_fn):
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
                                freqs, dense_fn,
                                cache.k_scale[i] if quant else None,
                                cache.v_scale[i] if quant else None)
    hidden = _ln(params["final_ln"], x, cfg.layer_norm_eps)
    logits = logits_fn(params, hidden[:, 0])
    cache.lengths.copy_(torch.where(active, pos + 1, pos))
    return cache, logits


def _verify_core(params, cfg: GPTConfig, cache: KVCache, tokens, *,
                 embed_fn, dense_fn, logits_fn):
    """Speculative verify over the dense cache: tokens (B, k1) — column 0
    each slot's pending token, columns 1.. its drafts; row j sits at
    ``lengths + j``. Returns (cache, logits (B, k1, V) fp32); lengths are
    not advanced. The caller keeps ``lengths + k1 <= S_max``."""
    pos = cache.lengths.clone()
    x = embed_fn(params, tokens, pos=pos)
    freqs = _rope_or_none(cfg, cache.k.shape[3], tokens.device)
    for i, lp in enumerate(_unstack(params["layers"], cfg.num_layers)):
        x = _block_verify(lp, x, cache.k[i], cache.v[i], pos, cfg, freqs,
                          dense_fn)
    hidden = _ln(params["final_ln"], x, cfg.layer_norm_eps)
    return cache, logits_fn(params, hidden)


def _tree_verify_core(params, cfg: GPTConfig, cache: KVCache, tokens,
                      depth, anc, *, embed_fn, dense_fn, logits_fn):
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
                               anc, cfg, freqs, dense_fn)
    hidden = _ln(params["final_ln"], x, cfg.layer_norm_eps)
    return cache, logits_fn(params, hidden)


def _paged_verify_core(params, cfg: GPTConfig, cache: PagedKVCache,
                       tokens, *, embed_fn, dense_fn, logits_fn):
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
                                freqs, dense_fn,
                                cache.k_scale[i] if quant else None,
                                cache.v_scale[i] if quant else None)
    hidden = _ln(params["final_ln"], x, cfg.layer_norm_eps)
    return cache, logits_fn(params, hidden)


def _paged_tree_verify_core(params, cfg: GPTConfig, cache: PagedKVCache,
                            tokens, depth, anc, *, embed_fn, dense_fn,
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
                                     depth, anc, cfg, freqs, dense_fn)
    hidden = _ln(params["final_ln"], x, cfg.layer_norm_eps)
    return cache, logits_fn(params, hidden)


def _paged_chunk_prefill_core(params, cfg: GPTConfig,
                              cache: PagedKVCache, ids, mask, slot, pos,
                              write_pages, gather_row, store_row, *,
                              embed_fn, dense_fn, logits_fn):
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
                                       freqs, key_mask, dense_fn)
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
    if quantized:
        return _embed_w8(cfg, compute_dtype), _dense_w8, _logits_w8
    return _embed_unsharded(cfg, compute_dtype), _dense, _logits_unsharded


def make_prefill_fn(cfg: GPTConfig, compute_dtype=None,
                    quantized: bool = False):
    """``prefill(params, cache, ids, mask, slot) -> (cache, logits)``;
    the cache is updated in place. Call through a bucketing layer (the
    scheduler does) so prompts arrive at a few shapes. ``quantized``
    expects the weight-only int8 tree of ``quant.quantize_params``."""
    check_config(cfg)
    embed, dense_fn, logits_fn = _unsharded_fns(cfg, compute_dtype,
                                                quantized)

    def prefill(params, cache, ids, mask, slot):
        return _prefill_core(params, cfg, cache, ids, mask, slot,
                             embed_fn=embed, dense_fn=dense_fn,
                             logits_fn=logits_fn)

    return prefill


def make_decode_fn(cfg: GPTConfig, compute_dtype=None,
                   quantized: bool = False):
    """``decode(params, cache, tokens, active) -> (cache, logits)``; the
    cache is updated in place and every slot advances together."""
    check_config(cfg)
    embed, dense_fn, logits_fn = _unsharded_fns(cfg, compute_dtype,
                                                quantized)

    def decode(params, cache, tokens, active):
        return _decode_core(params, cfg, cache, tokens, active,
                            embed_fn=embed, dense_fn=dense_fn,
                            logits_fn=logits_fn)

    return decode


def make_paged_prefill_fn(cfg: GPTConfig, compute_dtype=None,
                          quantized=False):
    """``prefill(params, cache, ids, mask, slot, write_pages, table_row)
    -> (cache, logits)`` over the page pool, updated in place."""
    check_config(cfg)
    embed, dense_fn, logits_fn = _unsharded_fns(cfg, compute_dtype,
                                                quantized)

    def prefill(params, cache, ids, mask, slot, write_pages, table_row):
        return _paged_prefill_core(params, cfg, cache, ids, mask, slot,
                                   write_pages, table_row, embed_fn=embed,
                                   dense_fn=dense_fn, logits_fn=logits_fn)

    return prefill


def make_paged_decode_fn(cfg: GPTConfig, compute_dtype=None,
                         quantized=False):
    """``decode(params, cache, tokens, active) -> (cache, logits)`` over
    the page pool, updated in place."""
    check_config(cfg)
    embed, dense_fn, logits_fn = _unsharded_fns(cfg, compute_dtype,
                                                quantized)

    def decode(params, cache, tokens, active):
        return _paged_decode_core(params, cfg, cache, tokens, active,
                                  embed_fn=embed, dense_fn=dense_fn,
                                  logits_fn=logits_fn)

    return decode


def make_verify_fn(cfg: GPTConfig, compute_dtype=None, quantized=False):
    """``verify(params, cache, tokens) -> (cache, logits (B, k1, V))``
    over the dense cache, updated in place; lengths are not advanced."""
    check_config(cfg)
    embed, dense_fn, logits_fn = _unsharded_fns(cfg, compute_dtype,
                                                quantized)

    def verify(params, cache, tokens):
        return _verify_core(params, cfg, cache, tokens, embed_fn=embed,
                            dense_fn=dense_fn, logits_fn=logits_fn)

    return verify


def make_paged_verify_fn(cfg: GPTConfig, compute_dtype=None,
                         quantized=False):
    """``verify(params, cache, tokens) -> (cache, logits (B, k1, V))``
    over the page pool, updated in place."""
    check_config(cfg)
    embed, dense_fn, logits_fn = _unsharded_fns(cfg, compute_dtype,
                                                quantized)

    def verify(params, cache, tokens):
        return _paged_verify_core(params, cfg, cache, tokens,
                                  embed_fn=embed, dense_fn=dense_fn,
                                  logits_fn=logits_fn)

    return verify


def make_tree_verify_fn(cfg: GPTConfig, compute_dtype=None,
                        quantized=False):
    """``verify(params, cache, tokens, depth, anc) -> (cache, logits
    (B, k1, V))`` over the dense cache (see :func:`_tree_verify_core`)."""
    check_config(cfg)
    embed, dense_fn, logits_fn = _unsharded_fns(cfg, compute_dtype,
                                                quantized)

    def verify(params, cache, tokens, depth, anc):
        return _tree_verify_core(params, cfg, cache, tokens, depth, anc,
                                 embed_fn=embed, dense_fn=dense_fn,
                                 logits_fn=logits_fn)

    return verify


def make_paged_tree_verify_fn(cfg: GPTConfig, compute_dtype=None,
                              quantized=False):
    """``verify(params, cache, tokens, depth, anc) -> (cache, logits)``
    over the page pool; an int8 pool raises the reference's
    ``ValueError``."""
    check_config(cfg)
    embed, dense_fn, logits_fn = _unsharded_fns(cfg, compute_dtype,
                                                quantized)

    def verify(params, cache, tokens, depth, anc):
        return _paged_tree_verify_core(params, cfg, cache, tokens, depth,
                                       anc, embed_fn=embed,
                                       dense_fn=dense_fn,
                                       logits_fn=logits_fn)

    return verify


def make_paged_chunk_prefill_fn(cfg: GPTConfig, compute_dtype=None,
                                quantized=False):
    """``chunk_prefill(params, cache, ids, mask, slot, pos, write_pages,
    gather_row, store_row) -> (cache, logits)`` over the page pool,
    updated in place (see :func:`_paged_chunk_prefill_core`)."""
    check_config(cfg)
    embed, dense_fn, logits_fn = _unsharded_fns(cfg, compute_dtype,
                                                quantized)

    def chunk_prefill(params, cache, ids, mask, slot, pos, write_pages,
                      gather_row, store_row):
        return _paged_chunk_prefill_core(
            params, cfg, cache, ids, mask, slot, pos, write_pages,
            gather_row, store_row, embed_fn=embed, dense_fn=dense_fn,
            logits_fn=logits_fn)

    return chunk_prefill


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

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
"""

import torch

from apex_tpu_torch.models.gpt import (
    GPTConfig, _block_decode, _block_prefill, _ln, _rope_or_none, _unstack,
    check_config,
)
from apex_tpu_torch.models.gpt import dense as _dense
from apex_tpu_torch.quant.kernels import w8_matmul, w8_matmul_nk
from apex_tpu_torch.serving.cache import KVCache


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


def _add_positions(cfg, params, x, ids, pos):
    """Learned positions (none under RoPE, which rotates q and k in the
    blocks instead)."""
    if cfg.use_rope:
        return x
    ptab = params["embedding"]["position"]["embedding"]
    if pos is None:
        return x + ptab[: ids.shape[1]].to(x.dtype)[None]
    # decode: slot b's token sits at absolute position pos[b]
    idx = pos[:, None].long() + torch.arange(
        ids.shape[1], device=ids.device)[None, :]
    return x + ptab[idx].to(x.dtype)


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

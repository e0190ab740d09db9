"""GPT (decoder-only transformer), the counterpart of
``apex_tpu/models/gpt.py``: inference (the serving blocks), training on
one device (``apply_gpt_unsharded`` with dropout, ``gpt_loss_unsharded``),
the tensor-, sequence- and context-parallel model (``GPTModel``) and the
pipeline adapter.

Parameters are a dict tree that mirrors the JAX tree, layer leaves
stacked on a leading ``num_layers`` axis; the JAX ``lax.scan`` over
layers is a Python loop, and ``cfg.remat`` checkpoints each layer
(``torch.utils.checkpoint``, with ``cfg.remat_policy`` mapped onto a
selective-checkpoint policy). Attention goes through the port's
``flash_attention`` (the kernel on the card), every norm through
``fused_layer_norm_affine``, the loss through the fused softmax cross
entropy, the hidden dropout through ``utils.prng.dropout``; the dense
products, RoPE, decode attention and embeddings are plain PyTorch, as
they are plain ``jnp`` in the JAX package. Positions are learned or
rotary (``use_rope``). The paged decode and verify blocks (bf16/fp32
and int8 pools, linear and tree masks) attend through
``paged_decode_attention`` and ``paged_verify_attention`` (one kernel on
the card; XLA in the JAX package), the paged prompt-chunk block through
``paged_chunk_attention`` (on the card a tensor-core kernel for a bf16
chunk, the verify kernel otherwise); the dense verify, tree and
prompt-chunk blocks are plain PyTorch, as they are XLA there.
Weight-only int8 trees run the serving blocks with
``serving/decode.py``'s w8 linears.

``GPTModel`` runs inside ``parallel_state.shard_map`` over the ``model``
axis, one process a rank: the qkv and fc1 products are
``ColumnParallelLinear``, out and fc2 ``RowParallelLinear``, the word
table a ``VocabParallelEmbedding`` tied to the logits, whose loss is
``vocab_parallel_cross_entropy`` (plain ops, no kernel, as in the JAX
package); the attention and LayerNorm kernels run on each rank's local
heads and tokens. The qkv columns are head-major, so a contiguous column
block holds whole heads. ``sequence_parallel`` splits the activations
outside the tensor-parallel regions along the sequence.
``context_parallel`` runs the whole model on this rank's block of the
sequence over the ``context`` axis, its attention ring or Ulysses
(``transformer.context_parallel``), RoPE and learned positions at the
block's global positions. The pipeline adapter
(``gpt_to_pipeline_params``, ``gpt_pipeline_partition_specs``,
``gpt_pipeline_model``) lays the params out as the pipeline schedules
take them.
"""

import dataclasses
import functools
import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts,
)

from apex_tpu_torch.amp.autocast import cast_args
from apex_tpu_torch.contrib.xentropy import softmax_cross_entropy_loss
from apex_tpu_torch.models._convert import params_from_jax  # noqa: F401
from apex_tpu_torch.normalization import fused_layer_norm_affine
from apex_tpu_torch.quant.kernels import kv_dequantize, kv_quantize
from apex_tpu_torch.transformer.functional import (
    flash_attention, fused_apply_rotary_pos_emb_bhsd, paged_decode_attention,
    paged_verify_attention, rope_frequencies,
)
from apex_tpu_torch.transformer import parallel_state as ps
from apex_tpu_torch.transformer import tensor_parallel as tp
from apex_tpu_torch.transformer.functional.paged_attention import (
    paged_chunk_attention, visible,
)
from apex_tpu_torch.utils import prng
from apex_tpu_torch.utils.platform import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class GPTConfig:
    vocab_size: int = 50304          # 50257 padded to a multiple of 128
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    ffn_hidden_size: int = 4096
    max_position_embeddings: int = 1024
    layer_norm_eps: float = 1e-5
    use_rope: bool = False           # learned absolute positions otherwise
    rope_base: float = 10000.0
    hidden_dropout: float = 0.1      # applied only when a key is given
    # checkpoint each layer: one hidden state a layer is kept and the
    # layer is recomputed in the backward
    remat: bool = False
    # a JAX checkpoint-policy name (``_REMAT_POLICIES``) under remat:
    # which of the layer's results are kept instead of recomputed
    remat_policy: Optional[str] = None
    # Megatron sequence parallelism (GPTModel): activations outside the
    # tensor-parallel regions (LN, residuals, dropout) are split along
    # the sequence (dim 1 of (b, s, h)) over the model axis
    sequence_parallel: bool = False
    # long-context parallelism: the whole model runs on a sequence block
    # (ids arrive (b, s/cp)) and attention is ring or Ulysses attention
    # over the ``context`` axis; composes with tp, not with
    # sequence_parallel
    context_parallel: bool = False
    # "ring" rotates k/v blocks (cp - 1 shifts, any head count) or
    # "ulysses" swaps sequence and heads by all-to-all (needs
    # (num_heads/tp) % cp == 0)
    context_parallel_impl: str = "ring"
    # GPTModel's linears emit fp32 weight gradients with no round trip
    # through the activations' dtype (linear_with_grad_accumulation)
    gradient_accumulation_fusion: bool = False

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


def gpt_medium() -> GPTConfig:
    """GPT-2 medium-class (h 1024, 24 layers, 16 heads, vocab 50304),
    per-layer remat on, as in the JAX package."""
    return GPTConfig(remat=True)


def gpt_tiny() -> GPTConfig:
    return GPTConfig(vocab_size=512, hidden_size=64, num_layers=4,
                     num_heads=8, ffn_hidden_size=128,
                     max_position_embeddings=64)


def draft_gpt_tiny() -> GPTConfig:
    """The 2-layer RoPE draft model paired with :func:`gpt_tiny` for
    speculative serving (same vocab)."""
    return GPTConfig(vocab_size=512, hidden_size=32, num_layers=2,
                     num_heads=4, ffn_hidden_size=64,
                     max_position_embeddings=128, use_rope=True)


def draft_gpt_medium() -> GPTConfig:
    """The RoPE draft model paired with :func:`gpt_medium` (same vocab,
    h 128, 2 layers, 4 heads)."""
    return GPTConfig(vocab_size=50304, hidden_size=128, num_layers=2,
                     num_heads=4, ffn_hidden_size=256,
                     max_position_embeddings=1024, use_rope=True)


def check_config(cfg: GPTConfig) -> None:
    """The parallel fields' checks of the reference's ``GPTModel`` that
    need no mesh, with its messages: sequence and context parallelism
    exclude each other, and the context-parallel attention is ring or
    Ulysses."""
    if cfg.sequence_parallel and cfg.context_parallel:
        raise ValueError(
            "sequence_parallel and context_parallel are mutually "
            "exclusive (different axes, different activation "
            "contracts)")
    if cfg.context_parallel_impl not in ("ring", "ulysses"):
        raise ValueError(
            f"context_parallel_impl must be 'ring' or 'ulysses', "
            f"got {cfg.context_parallel_impl!r}")


# ---------------------------------------------------------------------------
# init and weights carried across from the JAX package
# ---------------------------------------------------------------------------

def _gpt_tree(cfg: GPTConfig, dtype: torch.dtype, dev: torch.device,
              word: torch.Tensor, kernel, position) -> Dict[str, Any]:
    """The JAX ``init_gpt`` tree around the drawn leaves: ``word`` the
    word table, ``kernel(j, fan_in, shape)`` the stacked (L, ...) kernel
    of qkv, out, fc1, fc2 (j = 0..3, drawn in that order), ``position()``
    the position table, drawn last and only without RoPE; zero biases,
    unit LN weights (LN leaves fp32)."""
    h, f, L = cfg.hidden_size, cfg.ffn_hidden_size, cfg.num_layers

    def zeros(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=dev)

    def ln():
        return {"weight": torch.ones((L, h), device=dev),
                "bias": zeros(L, h, dt=torch.float32)}

    params: Dict[str, Any] = {
        "embedding": {"word": {"embedding": word}},
        "layers": {
            "ln1": ln(),
            "qkv": {"kernel": kernel(0, h, (h, 3 * h)),
                    "bias": zeros(L, 3 * h)},
            "out": {"kernel": kernel(1, h, (h, h)), "bias": zeros(L, h)},
            "ln2": ln(),
            "fc1": {"kernel": kernel(2, h, (h, f)), "bias": zeros(L, f)},
            "fc2": {"kernel": kernel(3, f, (f, h)), "bias": zeros(L, h)},
        },
        "final_ln": {"weight": torch.ones((h,), device=dev),
                     "bias": zeros(h, dt=torch.float32)},
    }
    if not cfg.use_rope:
        params["embedding"]["position"] = {"embedding": position()}
    return params


def init_gpt(cfg: GPTConfig, generator: torch.Generator,
             dtype: torch.dtype = torch.float32,
             device: DeviceLike = None) -> Dict[str, Any]:
    """Random params with the JAX ``init_gpt`` distributions: dense
    kernels N(0, 1/fan_in), embeddings N(0, 0.02^2), zero biases, unit
    LN weights (LN leaves fp32); no position table under RoPE. Drawn on
    ``generator``'s device, then moved to ``device``."""
    check_config(cfg)
    dev = resolve_device(device)
    h = cfg.hidden_size

    def normal(shape, std):
        x = torch.randn(shape, generator=generator, dtype=dtype,
                        device=generator.device) * std
        return x.to(dev)

    return _gpt_tree(
        cfg, dtype, dev, normal((cfg.vocab_size, h), 0.02),
        lambda j, fan_in, shape: normal((cfg.num_layers,) + shape,
                                        math.sqrt(1.0 / fan_in)),
        lambda: normal((cfg.max_position_embeddings, h), 0.02))


def init_gpt_from_key(key, cfg: GPTConfig,
                      dtype: torch.dtype = torch.float32,
                      device: DeviceLike = None) -> Dict[str, Any]:
    """The JAX ``init_gpt(key, cfg)`` tree from the same ``utils.prng``
    key: the same splits and ``normal`` draws (each layer on its own key
    of ``split(k_layers, num_layers)``, as the JAX ``vmap`` draws them),
    so the weights equal the JAX package's within ``prng.normal_limit``
    times their scale. fp32 draws only, like ``prng.normal``."""
    check_config(cfg)
    dev = resolve_device(device)
    h = cfg.hidden_size
    k_emb, k_pos, k_layers = prng.split(key, 3)

    def normal(k, shape, std):
        return (prng.normal(k, shape, dtype, device=dev) * std).to(dtype)

    def kernel(j, fan_in, shape):
        return torch.stack([normal(prng.split(k, 4)[j], shape,
                                   math.sqrt(1.0 / fan_in))
                            for k in prng.split(k_layers, cfg.num_layers)])

    return _gpt_tree(
        cfg, dtype, dev, normal(k_emb, (cfg.vocab_size, h), 0.02), kernel,
        lambda: normal(k_pos, (cfg.max_position_embeddings, h), 0.02))


def _unstack(layers: Dict[str, Any], n: int):
    """Every layer's slice of the stacked leaves (views), by one
    ``unbind`` a leaf: its backward stacks the layers' gradients once,
    where indexing one layer at a time would give each layer's gradient
    as a zero-filled (L, ...) tensor and add L of them."""
    cols = {name: {k: v.unbind(0) for k, v in p.items()}
            for name, p in layers.items()}
    return [{name: {k: vs[i] for k, vs in p.items()}
             for name, p in cols.items()} for i in range(n)]


# ---------------------------------------------------------------------------
# shared block math
# ---------------------------------------------------------------------------

def _ln(p, x, eps):
    return fused_layer_norm_affine(x, p["weight"], p["bias"],
                                   x.shape[-1], eps).to(x.dtype)


def _split_qkv(q_k_v: torch.Tensor, hd: int):
    """(b, s, 3*h) head-major -> three (b, nh, s, hd) views."""
    b, s, w = q_k_v.shape
    nh = w // (3 * hd)
    qkv = q_k_v.reshape(b, s, nh, 3, hd)
    return tuple(qkv[:, :, :, j].transpose(1, 2) for j in range(3))


def _merge_heads(ctx: torch.Tensor) -> torch.Tensor:
    b, _, s, _ = ctx.shape
    return ctx.transpose(1, 2).reshape(b, s, -1)


def _rotate(q, k, rope_freqs, positions=None):
    """RoPE on q and k (no-op without a table)."""
    if rope_freqs is None:
        return q, k
    return (fused_apply_rotary_pos_emb_bhsd(q, rope_freqs, positions),
            fused_apply_rotary_pos_emb_bhsd(k, rope_freqs, positions))


def _causal_attention(q_k_v: torch.Tensor, cfg: GPTConfig,
                      rope_freqs: Optional[torch.Tensor]) -> torch.Tensor:
    """(b, s, 3*h) -> (b, s, h); qkv columns are head-major
    ``[head0: q k v | head1: q k v | ...]``."""
    hd = cfg.head_dim
    q, k, v = _split_qkv(q_k_v, hd)
    q, k = _rotate(q, k, rope_freqs)
    ctx = flash_attention(q, k, v, causal=True,
                          softmax_scale=1.0 / math.sqrt(hd))
    return _merge_heads(ctx)


def _cp_attention(q_k_v, cfg, rope_freqs, attn_fn):
    """Context-parallel attention: the head-major split, RoPE on this
    rank's block (``rope_freqs`` already at its global positions),
    ``attn_fn`` over the ``context`` axis, the heads merged back."""
    hd = cfg.head_dim
    q, k, v = _split_qkv(q_k_v, hd)
    q, k = _rotate(q, k, rope_freqs)
    ctx = attn_fn(q, k, v, causal=True, softmax_scale=1.0 / math.sqrt(hd))
    return _merge_heads(ctx)


def _ring_causal_attention(q_k_v: torch.Tensor, cfg: GPTConfig,
                           rope_freqs: Optional[torch.Tensor]
                           ) -> torch.Tensor:
    """:func:`_cp_attention` through ``ring_attention``."""
    from apex_tpu_torch.transformer.context_parallel import ring_attention

    return _cp_attention(q_k_v, cfg, rope_freqs, ring_attention)


def _ulysses_causal_attention(q_k_v: torch.Tensor, cfg: GPTConfig,
                              rope_freqs: Optional[torch.Tensor]
                              ) -> torch.Tensor:
    """:func:`_cp_attention` through ``ulysses_attention`` (the flash
    kernel over the whole sequence for h/cp heads)."""
    from apex_tpu_torch.transformer.context_parallel import (
        ulysses_attention,
    )

    return _cp_attention(q_k_v, cfg, rope_freqs, ulysses_attention)


_CP_ATTN = {"ring": _ring_causal_attention,
            "ulysses": _ulysses_causal_attention}


def _gelu(x):
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


def _mlp(lp, x, cfg, fc1_fn, fc2_fn):
    return fc2_fn(lp["fc2"], _gelu(fc1_fn(lp["fc1"], _ln(
        lp["ln2"], x, cfg.layer_norm_eps))))


def _maybe_dropout(x, rate, rng, salt):
    """``x * bernoulli(fold_in(rng, salt), 1 - rate) / (1 - rate)`` as
    the JAX package's GPT writes it, through the fused threefry
    dropout."""
    if rng is None or rate <= 0:
        return x
    return prng.dropout(prng.fold_in(rng, salt), x, rate)


def _block(lp, x, cfg, rope_freqs, qkv_fn, out_fn, fc1_fn, fc2_fn,
           dropout_rng=None, ring=False):
    """Pre-LN transformer block: x + Attn(LN(x)); x + MLP(LN(x)), the
    hidden dropout after the attention's output projection (salt 0)
    and after fc2 (salt 1). The four linears are ``dense`` on the
    unsharded path, the Column / Row layers' ``apply`` in GPTModel.
    ``ring`` selects ``cfg.context_parallel_impl``'s attention (an
    execution path, not the config: the unsharded model runs the same
    config with plain attention)."""
    attn = _CP_ATTN[cfg.context_parallel_impl] if ring \
        else _causal_attention
    att = attn(qkv_fn(lp["qkv"], _ln(lp["ln1"], x, cfg.layer_norm_eps)),
               cfg, rope_freqs)
    att = _maybe_dropout(out_fn(lp["out"], att), cfg.hidden_dropout,
                         dropout_rng, 0)
    x = x + att
    mlp = fc2_fn(lp["fc2"], _gelu(fc1_fn(lp["fc1"], _ln(
        lp["ln2"], x, cfg.layer_norm_eps))))
    mlp = _maybe_dropout(mlp, cfg.hidden_dropout, dropout_rng, 1)
    return x + mlp


def _prefill_attention(q_k_v: torch.Tensor, cfg: GPTConfig,
                       rope_freqs: Optional[torch.Tensor],
                       key_mask: Optional[torch.Tensor]):
    """Like :func:`_causal_attention` but also returns the (rotated) k
    and v tiles for the cache, and takes a (b, s) ``key_mask`` (1 = real
    token) so a bucket-padded prompt's pad tail is never a key."""
    hd = cfg.head_dim
    q, k, v = _split_qkv(q_k_v, hd)
    q, k = _rotate(q, k, rope_freqs)
    ctx = flash_attention(q, k, v, key_mask, causal=True,
                          softmax_scale=1.0 / math.sqrt(hd))
    return _merge_heads(ctx), k, v


def _decode_attention(q_k_v: torch.Tensor, k_cache: torch.Tensor,
                      v_cache: torch.Tensor, pos: torch.Tensor,
                      cfg: GPTConfig, rope_freqs: Optional[torch.Tensor]):
    """Single-query attention against one layer's per-slot cache: the
    one-column :func:`_verify_attention`.

    ``q_k_v`` (b, 1, 3*h); ``k_cache``/``v_cache`` (b, nh, S_max, hd),
    written IN PLACE; ``pos`` (b,) each slot's current length, the new
    token's absolute position (RoPE rotates q and k there). The new k/v
    row is written at ``pos`` (clamped to the last row, as the JAX
    ``dynamic_update_slice`` clamps) BEFORE attending, so the ``s <=
    pos`` mask only admits rows that hold real tokens. Scores and
    softmax in fp32; returns ctx (b, 1, h)."""
    return _verify_attention(q_k_v, k_cache, v_cache, pos, cfg, rope_freqs)


def _block_prefill(lp, x, cfg, rope_freqs, key_mask, qkv_fn, out_fn, fc1_fn,
                   fc2_fn):
    """:func:`_block` (no dropout) that also returns this layer's (k, v)
    tiles."""
    att, k, v = _prefill_attention(
        qkv_fn(lp["qkv"], _ln(lp["ln1"], x, cfg.layer_norm_eps)), cfg,
        rope_freqs, key_mask)
    x = x + out_fn(lp["out"], att)
    return x + _mlp(lp, x, cfg, fc1_fn, fc2_fn), k, v


def _block_decode(lp, x, k_cache, v_cache, pos, cfg, rope_freqs, qkv_fn,
                  out_fn, fc1_fn, fc2_fn):
    """:func:`_block` against one layer's cache (updated in place): x is
    the (b, 1, h) new-token hidden."""
    att = _decode_attention(
        qkv_fn(lp["qkv"], _ln(lp["ln1"], x, cfg.layer_norm_eps)), k_cache,
        v_cache, pos, cfg, rope_freqs)
    x = x + out_fn(lp["out"], att)
    return x + _mlp(lp, x, cfg, fc1_fn, fc2_fn)


def _q8_page_insert(pool, scale, pages, rows, new_row, rescale=True,
                    zero_dead=False):
    """Insert ``new_row`` (b, nh, hd) fp32 into the int8 page ``pages``
    of each slot at row ``rows`` by a whole-page read-modify-write
    requant, IN PLACE: dequantize the page, set the exact new row,
    recompute the per-head amax scale over the whole page, requantize
    and scatter page and scale back. Re-quantizing untouched rows at an
    unchanged scale is round-to-nearest idempotent, so a page whose amax
    the new row does not raise comes back bit-identical.

    The verify steps pass ``zero_dead=True``: the rows past the insert
    (stale or speculative, never admitted by a mask) are zeroed before
    the amax, so the scale is a function of live rows only, and two runs
    that drafted different rejected tails requantize alike.
    ``rescale=False`` (a verify's columns j >= 1) keeps the page's scale
    unless the row lands at page row 0: the new row quantizes (clipped)
    against it, so a speculative row never re-rounds committed history
    (the JAX ``_q8_page_insert``)."""
    b = pages.shape[0]
    old = scale[pages]                                 # (b, nh)
    tile = kv_dequantize(pool[pages], old)             # (b, nh, page, hd)
    tile[torch.arange(b, device=pages.device), :, rows] = new_row
    if zero_dead:
        live = torch.arange(tile.shape[2], device=pages.device)[
            None, None, :, None] <= rows[:, None, None, None]
        tile = torch.where(live, tile, torch.zeros((), device=tile.device))
    nq, ns = kv_quantize(tile)
    if not rescale:
        keep = (rows > 0)[:, None]                     # (b, 1) over heads
        sel = torch.where(keep, old, ns)
        safe = torch.where(sel > 0, sel, torch.ones(
            (), device=sel.device))[..., None, None]
        qk = torch.clamp(torch.round(tile / safe), -127, 127).to(pool.dtype)
        nq = torch.where(keep[..., None, None], qk, nq)
        ns = sel
    pool[pages] = nq
    scale[pages] = ns


def _paged_decode_attention(q_k_v, k_pages, v_pages, block_tables, pos,
                            cfg: GPTConfig,
                            rope_freqs: Optional[torch.Tensor],
                            k_scale=None, v_scale=None):
    """Single-query attention against one layer's paged pool (the JAX
    package's ``_paged_decode_attention``, and with ``k_scale`` /
    ``v_scale`` its ``_paged_decode_attention_q8``).

    ``q_k_v`` (b, 1, 3*h); ``k_pages``/``v_pages`` (num_pages, nh,
    page_size, hd), written IN PLACE (an int8 pool with its (num_pages,
    nh) fp32 scales); ``block_tables`` (b, max_pages) int32; ``pos``
    (b,) int32 each slot's length, the new token's position (RoPE
    rotates q and k there). The new row is written into physical page
    ``block_tables[b, pos // page_size]`` at row ``pos % page_size``
    BEFORE attending (an int8 page by :func:`_q8_page_insert`); the
    attention over the logical positions ``0..pos`` is
    ``paged_decode_attention`` (the kernel on the card). Rows past
    ``pos`` take no part, so the logits do not depend on the physical
    page assignment. Returns ctx (b, 1, h)."""
    b = q_k_v.shape[0]
    q, k, v = _split_qkv(q_k_v, cfg.head_dim)       # (b, nh, 1, hd)
    q, k = _rotate(q, k, rope_freqs, positions=pos)
    logical = torch.clamp(pos.long() // k_pages.shape[2], 0,
                          block_tables.shape[1] - 1)
    pages = block_tables.gather(1, logical[:, None])[:, 0].long()
    rows = pos.long() % k_pages.shape[2]
    if k_scale is None:
        k_pages[pages, :, rows] = k[:, :, 0].to(k_pages.dtype)
        v_pages[pages, :, rows] = v[:, :, 0].to(v_pages.dtype)
    else:
        _q8_page_insert(k_pages, k_scale, pages, rows, k[:, :, 0].float())
        _q8_page_insert(v_pages, v_scale, pages, rows, v[:, :, 0].float())
    ctx = paged_decode_attention(q[:, :, 0].contiguous(), k_pages, v_pages,
                                 block_tables, pos, k_scale, v_scale)
    return ctx.reshape(b, 1, -1)


def _block_decode_paged(lp, x, k_pages, v_pages, block_tables, pos, cfg,
                        rope_freqs, qkv_fn, out_fn, fc1_fn, fc2_fn,
                        k_scale=None, v_scale=None):
    """:func:`_block_decode` over one layer's paged pool (and an int8
    pool's scales)."""
    att = _paged_decode_attention(
        qkv_fn(lp["qkv"], _ln(lp["ln1"], x, cfg.layer_norm_eps)), k_pages,
        v_pages, block_tables, pos, cfg, rope_freqs, k_scale, v_scale)
    x = x + out_fn(lp["out"], att)
    return x + _mlp(lp, x, cfg, fc1_fn, fc2_fn)


def _write_rows(cache, new, start):
    """Write ``new`` (b, nh, k1, hd) into ``cache`` (b, nh, S, hd) at rows
    ``start .. start + k1 - 1`` of each slot, the start clamped so the
    block fits, as ``lax.dynamic_update_slice`` clamps."""
    b, _, k1, _ = new.shape
    start = start.long().clamp(0, cache.shape[2] - k1)
    idx = start[:, None] + torch.arange(k1, device=start.device)[None, :]
    cache[torch.arange(b, device=start.device)[:, None], :, idx] = \
        new.transpose(1, 2).to(cache.dtype)


def _cache_attention(q, k_cache, v_cache, vis, dtype):
    """fp32 attention of q (b, nh, q, hd) over a (b, nh, S, hd) cache,
    ``vis`` (b, q, S) the admitted rows (``finfo.min`` elsewhere, so
    their probabilities are exactly 0); ctx (b, q, h) in ``dtype``. The
    scores are scaled (times 1/sqrt(hd)) and normalised as the
    prefill's plain attention does (``flash_attention.attention_probs``),
    so an fp32 cache's final prompt chunk gives a one-shot prefill's
    bits."""
    scores = torch.matmul(q.float(), k_cache.float().transpose(-1, -2)) \
        * (1.0 / math.sqrt(q.shape[-1]))
    scores = torch.where(vis[:, None], scores,
                         torch.finfo(torch.float32).min)
    probs = torch.softmax(scores, dim=-1)
    return _merge_heads(torch.matmul(probs, v_cache.float()).to(dtype))


def _verify_attention(q_k_v: torch.Tensor, k_cache: torch.Tensor,
                      v_cache: torch.Tensor, pos: torch.Tensor,
                      cfg: GPTConfig, rope_freqs: Optional[torch.Tensor]):
    """Speculative verify attention against one layer's per-slot cache:
    the k1-query :func:`_decode_attention`. ``q_k_v`` (b, k1, 3*h), the
    pending token and the drafts; query j sits at ``pos + j`` (RoPE
    rotates from ``pos``). All k1 rows are written (in place) BEFORE
    attending, and the mask ``s <= pos + j`` admits the committed rows
    and the candidate's own prefix, so logits row j is a teacher-forced
    forward at ``pos + j``; rows past the accepted prefix are never
    admitted before a later step rewrites them. The caller keeps ``pos
    + k1 <= S_max``. Returns ctx (b, k1, h)."""
    k1 = q_k_v.shape[1]
    q, k, v = _split_qkv(q_k_v, cfg.head_dim)        # (b, nh, k1, hd)
    q, k = _rotate(q, k, rope_freqs, positions=pos)
    _write_rows(k_cache, k, pos)
    _write_rows(v_cache, v, pos)
    s_idx = torch.arange(k_cache.shape[2], device=pos.device)
    qpos = pos.long()[:, None] + torch.arange(k1, device=pos.device)
    vis = s_idx[None, None, :] <= qpos[:, :, None]
    return _cache_attention(q, k_cache, v_cache, vis, q_k_v.dtype)


def _block_verify(lp, x, k_cache, v_cache, pos, cfg, rope_freqs, qkv_fn,
                  out_fn, fc1_fn, fc2_fn):
    """:func:`_block_decode` over k1 candidate positions at once."""
    att = _verify_attention(
        qkv_fn(lp["qkv"], _ln(lp["ln1"], x, cfg.layer_norm_eps)), k_cache,
        v_cache, pos, cfg, rope_freqs)
    x = x + out_fn(lp["out"], att)
    return x + _mlp(lp, x, cfg, fc1_fn, fc2_fn)


def _tree_score_mask(pos, anc, s_max):
    """(b, k1, s_max) bool: key position s admitted for query node j —
    ``s < pos`` (committed history), or window node ``i = s - pos`` with
    ``anc[b, i, j]`` (ancestor-or-self), as the JAX ``_tree_score_mask``
    (which returns it as (b, 1, k1, s_max))."""
    return visible(pos, anc.shape[1], s_max, anc)


def _tree_verify_attention(q_k_v: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, pos: torch.Tensor,
                           depth: torch.Tensor, anc: torch.Tensor,
                           cfg: GPTConfig,
                           rope_freqs: Optional[torch.Tensor]):
    """Tree-mask verify attention against one layer's per-slot cache:
    node j (topological order, node 0 the pending token) writes its row
    at physical row ``pos + j`` but attends (and rotates) at position
    ``pos + depth[j]``, seeing the committed rows and its ancestors
    (``anc`` (b, k1, k1) bool). Write-then-attend as
    :func:`_verify_attention`. Returns ctx (b, k1, h)."""
    q, k, v = _split_qkv(q_k_v, cfg.head_dim)
    if rope_freqs is not None:
        tpos = pos.long()[:, None] + depth.long()
        q, k = _rotate(q, k, rope_freqs, positions=tpos)
    _write_rows(k_cache, k, pos)
    _write_rows(v_cache, v, pos)
    vis = _tree_score_mask(pos, anc, k_cache.shape[2])
    return _cache_attention(q, k_cache, v_cache, vis, q_k_v.dtype)


def _block_tree_verify(lp, x, k_cache, v_cache, pos, depth, anc, cfg,
                       rope_freqs, qkv_fn, out_fn, fc1_fn, fc2_fn):
    """:func:`_block_verify` under the tree-attention mask."""
    att = _tree_verify_attention(
        qkv_fn(lp["qkv"], _ln(lp["ln1"], x, cfg.layer_norm_eps)), k_cache,
        v_cache, pos, depth, anc, cfg, rope_freqs)
    x = x + out_fn(lp["out"], att)
    return x + _mlp(lp, x, cfg, fc1_fn, fc2_fn)


def _paged_write_window(k_pages, v_pages, block_tables, pos, k, v,
                        k_scale=None, v_scale=None):
    """Write the k1 new rows (b, nh, k1, hd) of each slot at logical
    positions ``pos .. pos + k1 - 1`` through the block table, one
    position at a time (same-page rows compose). An int8 pool inserts by
    the whole-page requant with ``rescale=(j == 0)`` and
    ``zero_dead=True``."""
    page_size = k_pages.shape[2]
    for j in range(k.shape[2]):
        p = pos.long() + j
        logical = torch.clamp(p // page_size, 0, block_tables.shape[1] - 1)
        pages = block_tables.gather(1, logical[:, None])[:, 0].long()
        rows = p % page_size
        if k_scale is None:
            k_pages[pages, :, rows] = k[:, :, j].to(k_pages.dtype)
            v_pages[pages, :, rows] = v[:, :, j].to(v_pages.dtype)
        else:
            _q8_page_insert(k_pages, k_scale, pages, rows,
                            k[:, :, j].float(), rescale=(j == 0),
                            zero_dead=True)
            _q8_page_insert(v_pages, v_scale, pages, rows,
                            v[:, :, j].float(), rescale=(j == 0),
                            zero_dead=True)


def _paged_verify_attention(q_k_v, k_pages, v_pages, block_tables, pos,
                            cfg: GPTConfig,
                            rope_freqs: Optional[torch.Tensor],
                            k_scale=None, v_scale=None):
    """Verify attention against one layer's paged pool: the JAX
    ``_paged_verify_attention`` and, with ``k_scale`` / ``v_scale``, its
    ``_paged_verify_attention_q8``. The k1 rows are written through the
    block table (:func:`_paged_write_window`; the host has made every
    written page exclusive, ``prepare_decode(..., n_new=k1)``), then
    ``paged_verify_attention`` (the kernel on the card) attends with the
    linear mask ``s <= pos + j``. Returns ctx (b, k1, h)."""
    q, k, v = _split_qkv(q_k_v, cfg.head_dim)        # (b, nh, k1, hd)
    q, k = _rotate(q, k, rope_freqs, positions=pos)
    _paged_write_window(k_pages, v_pages, block_tables, pos, k, v,
                        k_scale, v_scale)
    return _merge_heads(paged_verify_attention(
        q.contiguous(), k_pages, v_pages, block_tables, pos, None, k_scale,
        v_scale))


def _block_verify_paged(lp, x, k_pages, v_pages, block_tables, pos, cfg,
                        rope_freqs, qkv_fn, out_fn, fc1_fn, fc2_fn,
                        k_scale=None, v_scale=None):
    """:func:`_block_verify` over one layer's paged pool (and an int8
    pool's scales: the JAX ``_block_verify_paged_q8``)."""
    att = _paged_verify_attention(
        qkv_fn(lp["qkv"], _ln(lp["ln1"], x, cfg.layer_norm_eps)), k_pages,
        v_pages, block_tables, pos, cfg, rope_freqs, k_scale, v_scale)
    x = x + out_fn(lp["out"], att)
    return x + _mlp(lp, x, cfg, fc1_fn, fc2_fn)


def _paged_tree_verify_attention(q_k_v, k_pages, v_pages, block_tables,
                                 pos, depth, anc, cfg: GPTConfig,
                                 rope_freqs: Optional[torch.Tensor]):
    """:func:`_tree_verify_attention` over one layer's paged pool: node j
    written at logical position ``pos + j``, rotated at ``pos +
    depth[j]``, attending through ``paged_verify_attention`` under
    ``anc``. Not offered over the int8 pool (the JAX package refuses it:
    a branch commit would re-round history at branch-dependent scales).
    Returns ctx (b, k1, h)."""
    if k_pages.dtype == torch.int8:
        raise ValueError("tree verify is not offered over the int8 page "
                         "pool (kv8 keeps linear speculation)")
    q, k, v = _split_qkv(q_k_v, cfg.head_dim)
    if rope_freqs is not None:
        tpos = pos.long()[:, None] + depth.long()
        q, k = _rotate(q, k, rope_freqs, positions=tpos)
    _paged_write_window(k_pages, v_pages, block_tables, pos, k, v)
    return _merge_heads(paged_verify_attention(
        q.contiguous(), k_pages, v_pages, block_tables, pos,
        anc.contiguous()))


def _block_tree_verify_paged(lp, x, k_pages, v_pages, block_tables, pos,
                             depth, anc, cfg, rope_freqs, qkv_fn, out_fn,
                             fc1_fn, fc2_fn):
    """:func:`_block_tree_verify` over one layer's paged pool."""
    att = _paged_tree_verify_attention(
        qkv_fn(lp["qkv"], _ln(lp["ln1"], x, cfg.layer_norm_eps)), k_pages,
        v_pages, block_tables, pos, depth, anc, cfg, rope_freqs)
    x = x + out_fn(lp["out"], att)
    return x + _mlp(lp, x, cfg, fc1_fn, fc2_fn)


def _chunk_prefill_attention(q_k_v: torch.Tensor, k_cache: torch.Tensor,
                             v_cache: torch.Tensor, slot: int,
                             pos: torch.Tensor, cfg: GPTConfig,
                             rope_freqs: Optional[torch.Tensor],
                             key_mask: torch.Tensor):
    """One slot's prompt chunk against one layer's per-slot cache (the
    JAX ``_chunk_prefill_attention``, the prompt-sized
    :func:`_verify_attention`): ``q_k_v`` (1, sc, 3*h), token j at ``pos
    + j`` (``pos`` a 0-d int32); the chunk's k/v rows, pad rows zeroed by
    ``key_mask`` (1, sc), are written (in place) at ``pos`` BEFORE
    attending, so the mask ``s <= pos + j`` admits the earlier chunks and
    the token's own prefix, and row j is a teacher-forced forward at
    ``pos + j``. Plain PyTorch, as XLA computes it in the JAX package.
    Returns ctx (1, sc, h)."""
    sc = q_k_v.shape[1]
    p1 = pos.reshape(1)
    q, k, v = _split_qkv(q_k_v, cfg.head_dim)        # (1, nh, sc, hd)
    q, k = _rotate(q, k, rope_freqs, positions=p1)
    mz = key_mask.to(k.dtype)[:, None, :, None]
    kc, vc = k_cache[slot:slot + 1], v_cache[slot:slot + 1]
    _write_rows(kc, k * mz, p1)
    _write_rows(vc, v * mz, p1)
    s_idx = torch.arange(kc.shape[2], device=pos.device)
    qpos = p1.long()[:, None] + torch.arange(sc, device=pos.device)
    vis = s_idx[None, None, :] <= qpos[:, :, None]
    return _cache_attention(q, kc, vc, vis, q_k_v.dtype)


def _block_chunk_prefill(lp, x, k_cache, v_cache, slot, pos, cfg,
                         rope_freqs, key_mask, qkv_fn, out_fn, fc1_fn,
                         fc2_fn):
    """:func:`_block_verify` for one slot's prompt chunk."""
    att = _chunk_prefill_attention(
        qkv_fn(lp["qkv"], _ln(lp["ln1"], x, cfg.layer_norm_eps)), k_cache,
        v_cache, slot, pos, cfg, rope_freqs, key_mask)
    x = x + out_fn(lp["out"], att)
    return x + _mlp(lp, x, cfg, fc1_fn, fc2_fn)


def _paged_chunk_prefill_attention(q_k_v, k_pages, v_pages, write_pages,
                                   gather_row, pos, cfg: GPTConfig,
                                   rope_freqs: Optional[torch.Tensor],
                                   key_mask: torch.Tensor):
    """One slot's prompt chunk against one layer's paged pool (the JAX
    ``_paged_chunk_prefill_attention``): ``q_k_v`` (1, sc, 3*h), sc a
    multiple of the page size, token j at ``pos + j`` (``pos`` a 0-d
    int32); the chunk's rows (pad rows zeroed by ``key_mask`` (1, sc))
    are cut into page tiles and written to ``write_pages`` (shared pages
    redirected to scratch by the host), then every query attends the
    slot's ``gather_row`` ((max_pages,) int32) with the mask ``s <= pos
    + j``, through ``paged_chunk_attention``: on the card one launch of
    the chunk kernel (tensor cores) for bf16 q and pool, the verify
    kernel's slices otherwise (an fp32 chunk is a linear verify window of
    k1 = sc). The row is passed apart from the slot's stored block-table
    row, which the scheduler parks on scratch until the final chunk.
    Returns ctx (1, sc, h)."""
    sc = q_k_v.shape[1]
    hd = cfg.head_dim
    page_size = k_pages.shape[2]
    q, k, v = _split_qkv(q_k_v, hd)                  # (1, nh, sc, hd)
    p1 = pos.reshape(1)
    q, k = _rotate(q, k, rope_freqs, positions=p1)
    mz = key_mask.to(k.dtype)[:, None, :, None]

    def tiles(t):
        # (1, nh, sc, hd) -> (sc // page, nh, page, hd)
        t = (t * mz)[0]
        t = t.reshape(t.shape[0], sc // page_size, page_size, hd)
        return t.transpose(0, 1).to(k_pages.dtype)

    write = write_pages.long()
    k_pages[write] = tiles(k)
    v_pages[write] = tiles(v)
    return _merge_heads(paged_chunk_attention(
        q.contiguous(), k_pages, v_pages, gather_row[None], p1))


def _block_chunk_prefill_paged(lp, x, k_pages, v_pages, write_pages,
                               gather_row, pos, cfg, rope_freqs, key_mask,
                               qkv_fn, out_fn, fc1_fn, fc2_fn):
    """:func:`_block_verify` for one slot's prompt chunk over the paged
    pool."""
    att = _paged_chunk_prefill_attention(
        qkv_fn(lp["qkv"], _ln(lp["ln1"], x, cfg.layer_norm_eps)), k_pages,
        v_pages, write_pages, gather_row, pos, cfg, rope_freqs, key_mask)
    x = x + out_fn(lp["out"], att)
    return x + _mlp(lp, x, cfg, fc1_fn, fc2_fn)


def dense(p, x):
    return torch.matmul(x, p["kernel"].to(x.dtype)) + p["bias"].to(x.dtype)


def _rope_or_none(cfg: GPTConfig, s: int, device: DeviceLike = None):
    if not cfg.use_rope:
        return None
    return rope_frequencies(cfg.head_dim, s, cfg.rope_base, device=device)


# ---------------------------------------------------------------------------
# the depth loop, optionally checkpointed per layer
# ---------------------------------------------------------------------------

# The zero-argument policies of jax.checkpoint_policies the JAX package
# accepts as ``remat_policy``.
_REMAT_POLICIES = frozenset((
    "checkpoint_dots", "checkpoint_dots_with_no_batch_dims",
    "dots_saveable", "dots_with_no_batch_dims_saveable",
    "everything_saveable", "nothing_saveable"))
# The matrix products whose outputs a "dots" policy keeps: the 2-D
# products of the linears (no batch dimensions) and the batched ones.
_MM_OPS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)
_DOT_OPS = _MM_OPS + (torch.ops.aten.bmm.default,
                      torch.ops.aten.baddbmm.default)


def _keep_ops(ops, ctx, func, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if ops is None or func in ops
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat_context(policy: Optional[str]):
    """The ``context_fn`` of ``torch.utils.checkpoint`` for a JAX policy
    name: None (full recompute) for no name and ``nothing_saveable``;
    otherwise a selective-checkpoint policy that keeps the outputs of
    the matrix products (``*dots*``; only the 2-D ones for
    ``*no_batch_dims*``) or of every op (``everything_saveable``)."""
    if policy is None or policy == "nothing_saveable":
        return None
    if policy not in _REMAT_POLICIES:
        raise ValueError(
            f"remat_policy {policy!r} is not a "
            "zero-arg jax.checkpoint_policies policy; pick one "
            f"of {sorted(_REMAT_POLICIES)} (factories like "
            "'save_only_these_names' need arguments and are "
            "not usable here)")
    ops = (None if policy == "everything_saveable"
           else _MM_OPS if "no_batch_dims" in policy else _DOT_OPS)
    return functools.partial(create_selective_checkpoint_contexts,
                             functools.partial(_keep_ops, ops))


def _scan_layers(x, layers, cfg, freqs, qkv_fn, out_fn, fc1_fn, fc2_fn,
                 dropout_rng, ring=False):
    """Depth loop over the stacked layer leaves, each layer checkpointed
    under ``cfg.remat``; with a key, layer i draws on
    ``split(dropout_rng, num_layers)[i]``."""
    def block(lp, x, rng):
        return _block(lp, x, cfg, freqs, qkv_fn, out_fn, fc1_fn, fc2_fn,
                      dropout_rng=rng, ring=ring)

    kw = None
    if cfg.remat and torch.is_grad_enabled():   # no backward: no remat
        kw = {"use_reentrant": False}
        if cfg.remat_policy:
            ctx = _remat_context(cfg.remat_policy)
            if ctx is not None:
                kw["context_fn"] = ctx
    keys = (prng.split(dropout_rng, cfg.num_layers)
            if dropout_rng is not None else [None] * cfg.num_layers)
    for lp, key in zip(_unstack(layers, cfg.num_layers), keys):
        x = checkpoint(block, lp, x, key, **kw) if kw else block(lp, x, key)
    return x


# ---------------------------------------------------------------------------
# the unsharded path (the JAX package's golden model and tp=1 step)
# ---------------------------------------------------------------------------

def apply_gpt_unsharded(params: Dict[str, Any], cfg: GPTConfig,
                        input_ids: torch.Tensor, *, dropout_rng=None,
                        compute_dtype: Optional[torch.dtype] = None
                        ) -> torch.Tensor:
    """ids (b, s) -> final hidden (b, s, h). ``dropout_rng`` (a
    ``utils.prng`` key) turns on the hidden dropout; with
    ``compute_dtype`` the word table is cast before the lookup and every
    linear's kernel to the activations' dtype."""
    check_config(cfg)
    s = input_ids.shape[1]
    table = params["embedding"]["word"]["embedding"]
    if compute_dtype is not None:
        table = table.to(compute_dtype)
    # F.embedding: its backward sums each row's gradients in a fixed
    # order, in fp32 for a bf16 table (the index backward would scatter
    # with atomics)
    x = F.embedding(input_ids, table)
    if not cfg.use_rope:
        pos = params["embedding"]["position"]["embedding"][:s]
        x = x + pos.to(x.dtype)[None]
    freqs = _rope_or_none(cfg, s, input_ids.device)
    x = _scan_layers(x, params["layers"], cfg, freqs, dense, dense, dense,
                     dense, dropout_rng)
    return _ln(params["final_ln"], x, cfg.layer_norm_eps)


def gpt_loss_unsharded(params: Dict[str, Any], cfg: GPTConfig,
                       input_ids: torch.Tensor, labels: torch.Tensor, *,
                       dropout_rng=None,
                       compute_dtype: Optional[torch.dtype] = None
                       ) -> torch.Tensor:
    """Mean cross entropy of the tied logits ``hidden @ table.T`` (in
    the hidden's dtype) against ``labels`` (the targets as given: shift
    upstream), through the fused softmax cross entropy, so the (b, s, V)
    log-softmax is never materialised."""
    hidden = apply_gpt_unsharded(params, cfg, input_ids,
                                 dropout_rng=dropout_rng,
                                 compute_dtype=compute_dtype)
    table = params["embedding"]["word"]["embedding"]
    # the op policy: under O1 (amp.autocast) both operands take the
    # compute dtype, elsewhere the product is as given
    logits = torch.matmul(*cast_args("matmul", hidden,
                                     table.to(hidden.dtype).t()))
    v = logits.shape[-1]
    nll = softmax_cross_entropy_loss(logits.reshape(-1, v),
                                     labels.reshape(-1))
    return nll.mean()


# ---------------------------------------------------------------------------
# the tensor-parallel path: call inside parallel_state.shard_map
# ---------------------------------------------------------------------------

def gpt_partition_specs(cfg: GPTConfig) -> Dict[str, Any]:
    """Megatron layout over the ``model`` axis (layer leaves carry the
    leading stacked-layer dimension)."""
    P = ps.PartitionSpec
    t = ps.TENSOR_AXIS
    specs = {
        "embedding": {"word": {"embedding": P(t, None)}},
        "layers": {
            "ln1": {"weight": P(None), "bias": P(None)},
            "qkv": {"kernel": P(None, None, t), "bias": P(None, t)},
            "out": {"kernel": P(None, t, None), "bias": P(None)},
            "ln2": {"weight": P(None), "bias": P(None)},
            "fc1": {"kernel": P(None, None, t), "bias": P(None, t)},
            "fc2": {"kernel": P(None, t, None), "bias": P(None)},
        },
        "final_ln": {"weight": P(), "bias": P()},
    }
    if not cfg.use_rope:
        specs["embedding"]["position"] = {"embedding": P()}
    return specs


def _tied_lm_logits(hidden: torch.Tensor,
                    table_local: torch.Tensor) -> torch.Tensor:
    """hidden (replicated) @ this rank's vocabulary block of the table,
    transposed, as fp32 logits: a ColumnParallelLinear in disguise. The
    hidden passes through ``copy_to_tensor_model_parallel_region``, so
    the backward all-reduces dhidden (each rank's product covers only its
    vocabulary block)."""
    hidden = tp.copy_to_tensor_model_parallel_region(hidden)
    return torch.matmul(hidden, table_local.to(hidden.dtype).t()).float()


class GPTModel:
    """The tensor-parallel layers (Column / Row / VocabParallel) of one
    config. ``apply`` / ``loss`` run inside ``parallel_state.shard_map``
    on this rank's block of the params; ``init`` and ``partition_specs``
    describe the whole params."""

    def __init__(self, cfg: GPTConfig, tp_size: Optional[int] = None):
        self.cfg = cfg
        h, f = cfg.hidden_size, cfg.ffn_hidden_size
        t = tp_size if tp_size is not None else \
            ps.get_tensor_model_parallel_world_size()
        if cfg.num_heads % t:
            raise ValueError(
                f"num_heads {cfg.num_heads} not divisible by tp {t} "
                "(attention heads shard over the model axis)")
        check_config(cfg)
        if cfg.context_parallel and cfg.context_parallel_impl == "ulysses":
            cp = ps.get_context_parallel_world_size()
            if (cfg.num_heads // t) % cp:
                raise ValueError(
                    f"ulysses context parallelism needs local heads "
                    f"({cfg.num_heads}//tp{t}) divisible by cp={cp}")
        sp = dict(sequence_parallel_enabled=cfg.sequence_parallel,
                  sequence_parallel_seq_dim=1,  # (b, s, h) layout
                  gradient_accumulation_fusion=
                  cfg.gradient_accumulation_fusion)
        self.qkv = tp.ColumnParallelLinear(h, 3 * h, gather_output=False,
                                           tp_size=tp_size, **sp)
        self.out = tp.RowParallelLinear(h, h, input_is_parallel=True,
                                        tp_size=tp_size, **sp)
        self.fc1 = tp.ColumnParallelLinear(h, f, gather_output=False,
                                           tp_size=tp_size, **sp)
        self.fc2 = tp.RowParallelLinear(f, h, input_is_parallel=True,
                                        tp_size=tp_size, **sp)
        self.embed = tp.VocabParallelEmbedding(cfg.vocab_size, h,
                                               tp_size=tp_size)

    def init(self, generator: torch.Generator,
             dtype: torch.dtype = torch.float32,
             device: DeviceLike = None) -> Dict[str, Any]:
        return init_gpt(self.cfg, generator, dtype, device)

    def partition_specs(self) -> Dict[str, Any]:
        return gpt_partition_specs(self.cfg)

    def apply(self, params: Dict[str, Any], input_ids: torch.Tensor, *,
              dropout_rng=None,
              compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """ids (b, s) -> final hidden (b, s, h), split on s under
        sequence parallelism. Inside shard_map over the ``model`` axis (a
        mesh of tp 1 is fine). Under context parallelism the ids are
        this rank's (b, s/cp) block on the ``context`` axis and the
        hidden is its block too."""
        cfg = self.cfg
        s = input_ids.shape[1]
        x = self.embed.apply(params["embedding"]["word"], input_ids)
        if compute_dtype is not None:
            x = x.to(compute_dtype)
        if cfg.context_parallel:
            # the positions and rotary angles of this rank's block are
            # the global ones, from offset rank * s
            at = ps.get_context_parallel_rank() * s
            if not cfg.use_rope:
                pos = params["embedding"]["position"]["embedding"][at:at + s]
                x = x + pos.to(x.dtype)[None]
            freqs = _rope_or_none(
                cfg, s * ps.get_context_parallel_world_size(),
                input_ids.device)
            if freqs is not None:
                freqs = freqs[at:at + s]
            if dropout_rng is not None:
                dropout_rng = prng.fold_in(dropout_rng,
                                           ps.get_context_parallel_rank())
            x = _scan_layers(x, params["layers"], cfg, freqs,
                             self.qkv.apply, self.out.apply, self.fc1.apply,
                             self.fc2.apply, dropout_rng, ring=True)
            return _ln(params["final_ln"], x, cfg.layer_norm_eps)
        if not cfg.use_rope:
            pos = params["embedding"]["position"]["embedding"][:s]
            x = x + pos.to(x.dtype)[None]
        freqs = _rope_or_none(cfg, s, input_ids.device)
        if cfg.sequence_parallel:
            # enter the SP region: the sequence split over the model
            # axis (the attention still sees all of it: Column gathers
            # it); ranks hold different tokens, so their dropout keys
            # differ
            x = tp.scatter_to_sequence_parallel_region(x, 1)
            if dropout_rng is not None:
                dropout_rng = prng.fold_in(
                    dropout_rng, ps.get_tensor_model_parallel_rank())
        x = _scan_layers(x, params["layers"], cfg, freqs, self.qkv.apply,
                         self.out.apply, self.fc1.apply, self.fc2.apply,
                         dropout_rng)
        return _ln(params["final_ln"], x, cfg.layer_norm_eps)

    def logits_local(self, params: Dict[str, Any],
                     hidden: torch.Tensor) -> torch.Tensor:
        """Tied LM head: (b, s, h) -> this rank's vocabulary block of the
        fp32 logits (b, s, V/tp) (the ``parallel_output=True``
        convention)."""
        return _tied_lm_logits(hidden,
                               params["embedding"]["word"]["embedding"])

    def allreduce_sequence_parallel_grads(self, grads: Dict[str, Any]
                                          ) -> Dict[str, Any]:
        """After the backward under sequence parallelism (ref: Megatron's
        ``allreduce_sequence_parallel_gradients``): the layer norms' and
        the Row-parallel biases' gradients cover only this rank's tokens;
        all-reduce them over the model axis. The identity without SP."""
        if not self.cfg.sequence_parallel:
            return grads

        def fix(tree, keys):
            if isinstance(tree, dict):
                return {k: fix(v, f"{keys}/{k}") for k, v in tree.items()}
            # the JAX package's test, by path substrings; the region's
            # forward is the all-reduce over the model axis
            if ("ln1" in keys or "ln2" in keys or "final_ln" in keys
                    or ("out" in keys and "bias" in keys)
                    or ("fc2" in keys and "bias" in keys)):
                return tp.reduce_from_tensor_model_parallel_region(tree)
            return tree

        return fix(grads, "")

    def loss(self, params: Dict[str, Any], input_ids: torch.Tensor,
             labels: torch.Tensor, *, dropout_rng=None,
             compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """Mean next-token loss through the vocab-parallel cross entropy
        (``labels`` the targets as given: shift upstream)."""
        hidden = self.apply(params, input_ids, dropout_rng=dropout_rng,
                            compute_dtype=compute_dtype)
        if self.cfg.sequence_parallel:
            # leave the SP region for the head: the gather's backward
            # reduce-scatters dhidden (the SP dual of copy_to_region)
            hidden = tp.gather_from_sequence_parallel_region(hidden, True, 1)
            table = params["embedding"]["word"]["embedding"]
            logits = torch.matmul(hidden, table.to(hidden.dtype).t()).float()
        else:
            logits = self.logits_local(params, hidden)
        loss = tp.vocab_parallel_cross_entropy(logits, labels).mean()
        if self.cfg.context_parallel:
            # the blocks are of one size: the global mean is the mean of
            # the ranks' means. As in the JAX package, each rank's
            # backward gives d(its own mean)/dp (the value is the mean,
            # the gradient passes as the identity): mean the GRADIENTS
            # over the context axis after the backward, as DDP does over
            # the batch
            mesh = ps.get_mesh()
            cp = mesh.shape[ps.CONTEXT_AXIS]
            if cp > 1:
                mean = tp.mappings.collective(
                    "all_reduce", loss, mesh.groups[ps.CONTEXT_AXIS],
                    mesh.members(ps.CONTEXT_AXIS)) / cp
                loss = loss + (mean - loss.detach())
        return loss


def gpt_tp_bench(on_tpu: bool, n_devices: int, *,
                 batch: Optional[int] = None, remat=False,
                 device: DeviceLike = None):
    """``(body, make_init, fetch, global_batch)`` of the JAX package's
    GPT train step at tp = ``n_devices``, in this rank's process:
    ``on_tpu`` takes ``gpt_medium()`` at batch 8, seq 1024 (the card's
    size), else ``gpt_tiny()`` at batch 2, seq 32; ids and labels zeros;
    bf16 compute over fp32 params; the tree ``FusedAdam(lr=1e-4,
    weight_decay=0.01)``; weights ``init_gpt_from_key(PRNGKey(0))``.
    ``remat`` overrides the config's both ways (a string names a JAX
    checkpoint policy). At tp 1 the step is the unsharded one
    (``examples/gpt/train.py``); above, the default process group must
    hold ``n_devices`` ranks: the model axis is installed over them and
    the step runs ``GPTModel.loss`` and its gradients inside
    ``shard_map(in_specs=(specs, P(), P()), out_specs=(P(), specs))``,
    each rank then stepping the whole params."""
    from apex_tpu_torch.examples.gpt.train import (
        make_gpt_tp_train_step, make_gpt_train_step,
    )
    from apex_tpu_torch.optimizers import FusedAdam

    dev = resolve_device(device)
    cfg = gpt_medium() if on_tpu else gpt_tiny()
    if isinstance(remat, str):
        cfg = dataclasses.replace(cfg, remat=True, remat_policy=remat)
    else:
        cfg = dataclasses.replace(cfg, remat=bool(remat))
    default_b, seq = (8, 1024) if on_tpu else (2, 32)
    batch = default_b if batch is None else batch
    ids = torch.zeros((batch, seq), dtype=torch.long, device=dev)
    labels = torch.zeros((batch, seq), dtype=torch.long, device=dev)
    opt = FusedAdam(lr=1e-4, weight_decay=0.01)
    if n_devices == 1:
        step = make_gpt_train_step(cfg, opt)
    else:
        ps.destroy_model_parallel()
        ps.initialize_model_parallel(tensor_model_parallel_size_=n_devices,
                                     device=dev)
        step = make_gpt_tp_train_step(GPTModel(cfg, tp_size=n_devices), opt)

    def make_init():
        params = init_gpt_from_key(prng.PRNGKey(0), cfg, device=dev)
        return params, opt.init(params)

    def body(state):
        p, o, _ = step(*state, ids, labels)
        return p, o

    def fetch(state):
        return state[0]["final_ln"]["weight"].sum()

    return body, make_init, fetch, batch


def accumulate_tied_word_grads(grads: Dict[str, Any]) -> Dict[str, Any]:
    """Sum the two pipeline-layout copies of the tied word-table gradient
    (``grads["embed"]["word"]``, the lookup's, and
    ``grads["head"]["word"]``, the logits head's) into both slots, so
    both copies take the same update and stay tied (Megatron's
    shared-embedding all-reduce). A dict operation: the tensors are
    added leaf by leaf."""
    grads = dict(grads)
    emb, head = grads["embed"]["word"], grads["head"]["word"]
    tied = {k: emb[k] + head[k] for k in emb}
    grads["embed"] = dict(grads["embed"], word=tied)
    grads["head"] = dict(grads["head"], word=tied)
    return grads


# ---------------------------------------------------------------------------
# the pipeline adapter: the {"embed", "stages", "head"} layout of the
# pipeline schedules
# ---------------------------------------------------------------------------

def gpt_to_pipeline_params(params: Dict[str, Any], cfg: GPTConfig,
                           pp: int, vpp: Optional[int] = None
                           ) -> Dict[str, Any]:
    """The stacked ``(L, ...)`` layer leaves as the schedules' stage
    stack: ``(pp, L/pp, ...)``, or ``(vpp, pp, L/(pp*vpp), ...)`` in the
    reference's round-robin chunk order (chunk c on rank c % pp, lane
    c // pp); views of the leaves. The word table appears twice, the
    lookup's copy under ``embed`` and the tied head's under ``head`` (a
    copy of its own, so the two copies can take their updates apart)."""
    L = cfg.num_layers
    chunks = pp * (vpp or 1)
    if L % chunks:
        raise ValueError(f"num_layers {L} not divisible by {chunks}")
    per = L // chunks

    def reshape(a):
        if vpp is None:
            return a.reshape((pp, per) + tuple(a.shape[1:]))
        # layer l -> chunk l // per; chunk c -> (lane c // pp, rank c % pp)
        return a.reshape((vpp, pp, per) + tuple(a.shape[1:]))

    word = params["embedding"]["word"]
    return {
        "embed": params["embedding"],
        "stages": {name: {k: reshape(v) for k, v in p.items()}
                   for name, p in params["layers"].items()},
        "head": {"final_ln": params["final_ln"],
                 "word": {k: v.clone() for k, v in word.items()}},
    }


def gpt_pipeline_partition_specs(cfg: GPTConfig,
                                 vpp: Optional[int] = None):
    """The specs of ``gpt_to_pipeline_params``' layout: the stage leaves
    gain a leading ``pipe``-split stage dimension (``(vpp, pp, per,
    ...)`` with vpp) and keep their Megatron ``model`` splits; the tied
    word table stays vocab-split over ``model`` in both its copies (a
    whole table would make the vocab-parallel cross entropy count
    sum_exp twice)."""
    P = ps.PartitionSpec
    base = gpt_partition_specs(cfg)

    def stage_spec(p):
        tail = tuple(p)[1:]  # the stacked-L dimension's entry goes
        if vpp is None:
            return P(ps.PIPE_AXIS, None, *tail)
        return P(None, ps.PIPE_AXIS, None, *tail)

    return {
        "embed": base["embedding"],
        "stages": {name: {k: stage_spec(v) for k, v in p.items()}
                   for name, p in base["layers"].items()},
        "head": {"final_ln": base["final_ln"],
                 "word": base["embedding"]["word"]},
    }


def gpt_pipeline_model(model: GPTModel):
    """A ``PipelineModel`` over ``model``'s tensor-parallel block; runs
    inside shard_map over the pipe and model axes (tp x pp). Under
    sequence parallelism the hidden state travels the pipe split on s;
    the stage's rotary table spans the global sequence; the loss is the
    vocab-parallel cross entropy on the head's copy of the table."""
    from apex_tpu_torch.transformer.pipeline_parallel.schedules import (
        PipelineModel,
    )

    cfg = model.cfg

    def embed_fn(embed_params, mb):
        ids = mb["input_ids"]
        x = model.embed.apply(embed_params["word"], ids)
        if not cfg.use_rope:
            pos = embed_params["position"]["embedding"][:ids.shape[1]]
            x = x + pos.to(x.dtype)[None]
        if cfg.sequence_parallel:
            # the hidden travels the pipe split on s; each stage's Column
            # layers gather it and its Row layers split it again
            x = tp.scatter_to_sequence_parallel_region(x, 1)
        return x

    def stage_fn(stage_params, x):
        # under SP the hidden arrives split on s (s/tp): the rotary angles
        # span the global sequence the Column gather puts back together
        s = x.shape[1]
        if cfg.sequence_parallel:
            s *= ps.get_tensor_model_parallel_world_size()
        freqs = _rope_or_none(cfg, s, x.device)
        per = next(iter(stage_params["ln1"].values())).shape[0]
        for lp in _unstack(stage_params, per):
            x = _block(lp, x, cfg, freqs, model.qkv.apply, model.out.apply,
                       model.fc1.apply, model.fc2.apply)
        return x

    def loss_fn(head_params, hidden, mb):
        hidden = _ln(head_params["final_ln"], hidden, cfg.layer_norm_eps)
        table = head_params["word"]["embedding"]
        if cfg.sequence_parallel:
            hidden = tp.gather_from_sequence_parallel_region(hidden, True, 1)
            logits = torch.matmul(hidden, table.to(hidden.dtype).t()).float()
        else:
            logits = _tied_lm_logits(hidden, table)
        return tp.vocab_parallel_cross_entropy(logits, mb["labels"]).mean()

    return PipelineModel(embed_fn, stage_fn, loss_fn)

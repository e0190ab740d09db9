"""GPT (decoder-only transformer), inference subset (counterpart of
``apex_tpu/models/gpt.py``).

Parameters are a dict tree that mirrors the JAX tree, layer leaves
stacked on a leading ``num_layers`` axis; the JAX ``lax.scan`` over
layers is a Python loop. Attention goes through the port's
``flash_attention`` (the kernel on the card) and every norm through
``fused_layer_norm_affine``; the dense products, decode attention and
embeddings are plain PyTorch, as they are plain ``jnp`` in the JAX
package. Learned positions only: RoPE, tensor/context parallelism and
the paged, verify and tree blocks are later slices. Weight-only int8
trees run these blocks with ``serving/decode.py``'s w8 linears.
"""

import dataclasses
import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from apex_tpu_torch.models._convert import params_from_jax  # noqa: F401
from apex_tpu_torch.normalization import fused_layer_norm_affine
from apex_tpu_torch.transformer.functional import flash_attention
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
    hidden_dropout: float = 0.1      # training only; inference ignores it

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


def gpt_medium() -> GPTConfig:
    """GPT-2 medium-class (h 1024, 24 layers, 16 heads, vocab 50304)."""
    return GPTConfig()


def gpt_tiny() -> GPTConfig:
    return GPTConfig(vocab_size=512, hidden_size=64, num_layers=4,
                     num_heads=8, ffn_hidden_size=128,
                     max_position_embeddings=64)


def check_config(cfg: GPTConfig) -> None:
    if cfg.use_rope:
        raise NotImplementedError(
            "RoPE is not ported yet (ROADMAP queue A: later slice); use "
            "learned positions (use_rope=False)")


# ---------------------------------------------------------------------------
# init and weights carried across from the JAX package
# ---------------------------------------------------------------------------

def init_gpt(cfg: GPTConfig, generator: torch.Generator,
             dtype: torch.dtype = torch.float32,
             device: DeviceLike = None) -> Dict[str, Any]:
    """Random params with the JAX ``init_gpt`` distributions: dense
    kernels N(0, 1/fan_in), embeddings N(0, 0.02^2), zero biases, unit
    LN weights (LN leaves fp32). Drawn on ``generator``'s device, then
    moved to ``device``."""
    check_config(cfg)
    dev = resolve_device(device)
    h, f, L = cfg.hidden_size, cfg.ffn_hidden_size, cfg.num_layers

    def normal(shape, std):
        x = torch.randn(shape, generator=generator, dtype=dtype,
                        device=generator.device) * std
        return x.to(dev)

    def dense(fan_in, shape):
        return normal((L,) + shape, math.sqrt(1.0 / fan_in))

    def zeros(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=dev)

    def ln():
        return {"weight": torch.ones((L, h), device=dev),
                "bias": zeros(L, h, dt=torch.float32)}

    params: Dict[str, Any] = {
        "embedding": {"word": {"embedding": normal((cfg.vocab_size, h),
                                                   0.02)}},
        "layers": {
            "ln1": ln(),
            "qkv": {"kernel": dense(h, (h, 3 * h)), "bias": zeros(L, 3 * h)},
            "out": {"kernel": dense(h, (h, h)), "bias": zeros(L, h)},
            "ln2": ln(),
            "fc1": {"kernel": dense(h, (h, f)), "bias": zeros(L, f)},
            "fc2": {"kernel": dense(f, (f, h)), "bias": zeros(L, h)},
        },
        "final_ln": {"weight": torch.ones((h,), device=dev),
                     "bias": zeros(h, dt=torch.float32)},
    }
    params["embedding"]["position"] = {"embedding": normal(
        (cfg.max_position_embeddings, h), 0.02)}
    return params


def layer(layers: Dict[str, Any], i: int) -> Dict[str, Any]:
    """Layer ``i``'s slice of the stacked layer leaves (views)."""
    return {name: {k: v[i] for k, v in p.items()}
            for name, p in layers.items()}


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


def _causal_attention(q_k_v: torch.Tensor, cfg: GPTConfig) -> torch.Tensor:
    """(b, s, 3*h) -> (b, s, h); qkv columns are head-major
    ``[head0: q k v | head1: q k v | ...]``."""
    hd = cfg.head_dim
    q, k, v = _split_qkv(q_k_v, hd)
    ctx = flash_attention(q, k, v, causal=True,
                          softmax_scale=1.0 / math.sqrt(hd))
    return _merge_heads(ctx)


def _gelu(x):
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


def _mlp(lp, x, cfg, dense):
    return dense(lp["fc2"], _gelu(dense(lp["fc1"], _ln(
        lp["ln2"], x, cfg.layer_norm_eps))))


def _block(lp, x, cfg, dense):
    """Pre-LN transformer block: x + Attn(LN(x)); x + MLP(LN(x))."""
    att = _causal_attention(dense(lp["qkv"], _ln(lp["ln1"], x,
                                                 cfg.layer_norm_eps)), cfg)
    x = x + dense(lp["out"], att)
    return x + _mlp(lp, x, cfg, dense)


def _prefill_attention(q_k_v: torch.Tensor, cfg: GPTConfig,
                       key_mask: Optional[torch.Tensor]):
    """Like :func:`_causal_attention` but also returns the k and v
    tiles for the cache, and takes a (b, s) ``key_mask`` (1 = real
    token) so a bucket-padded prompt's pad tail is never a key."""
    hd = cfg.head_dim
    q, k, v = _split_qkv(q_k_v, hd)
    ctx = flash_attention(q, k, v, key_mask, causal=True,
                          softmax_scale=1.0 / math.sqrt(hd))
    return _merge_heads(ctx), k, v


def _decode_attention(q_k_v: torch.Tensor, k_cache: torch.Tensor,
                      v_cache: torch.Tensor, pos: torch.Tensor,
                      cfg: GPTConfig):
    """Single-query attention against one layer's per-slot cache.

    ``q_k_v`` (b, 1, 3*h); ``k_cache``/``v_cache`` (b, nh, S_max, hd),
    written IN PLACE; ``pos`` (b,) each slot's current length. The new
    k/v row is written at ``pos`` (clamped to the last row, as the JAX
    ``dynamic_update_slice`` clamps) BEFORE attending, so the ``s <=
    pos`` mask only admits rows that hold real tokens. Scores and
    softmax in fp32; returns ctx (b, 1, h)."""
    b = q_k_v.shape[0]
    hd = cfg.head_dim
    q, k, v = _split_qkv(q_k_v, hd)            # (b, nh, 1, hd)
    s_max = k_cache.shape[2]
    rows = torch.arange(b, device=pos.device)
    wpos = pos.clamp(max=s_max - 1)
    k_cache[rows, :, wpos] = k[:, :, 0].to(k_cache.dtype)
    v_cache[rows, :, wpos] = v[:, :, 0].to(v_cache.dtype)
    scores = torch.matmul(q.float(), k_cache.float().transpose(-1, -2)) \
        / math.sqrt(hd)
    valid = torch.arange(s_max, device=pos.device)[None, None, None, :] \
        <= pos[:, None, None, None]
    scores = torch.where(valid, scores, torch.finfo(torch.float32).min)
    probs = torch.softmax(scores, dim=-1)
    ctx = torch.matmul(probs, v_cache.float()).to(q_k_v.dtype)
    return ctx.transpose(1, 2).reshape(b, 1, -1)


def _block_prefill(lp, x, cfg, key_mask, dense):
    """:func:`_block` that also returns this layer's (k, v) tiles."""
    att, k, v = _prefill_attention(
        dense(lp["qkv"], _ln(lp["ln1"], x, cfg.layer_norm_eps)), cfg,
        key_mask)
    x = x + dense(lp["out"], att)
    return x + _mlp(lp, x, cfg, dense), k, v


def _block_decode(lp, x, k_cache, v_cache, pos, cfg, dense):
    """:func:`_block` against one layer's cache (updated in place): x is
    the (b, 1, h) new-token hidden."""
    att = _decode_attention(
        dense(lp["qkv"], _ln(lp["ln1"], x, cfg.layer_norm_eps)), k_cache,
        v_cache, pos, cfg)
    x = x + dense(lp["out"], att)
    return x + _mlp(lp, x, cfg, dense)


def dense(p, x):
    return torch.matmul(x, p["kernel"].to(x.dtype)) + p["bias"].to(x.dtype)


def apply_gpt_unsharded(params: Dict[str, Any], cfg: GPTConfig,
                        input_ids: torch.Tensor, *,
                        compute_dtype: Optional[torch.dtype] = None
                        ) -> torch.Tensor:
    """ids (b, s) -> final hidden (b, s, h), no dropout; with
    ``compute_dtype`` the word table is cast before the lookup."""
    check_config(cfg)
    s = input_ids.shape[1]
    table = params["embedding"]["word"]["embedding"]
    if compute_dtype is not None:
        table = table.to(compute_dtype)
    x = table[input_ids]
    pos = params["embedding"]["position"]["embedding"][:s]
    x = x + pos.to(x.dtype)[None]
    layers = params["layers"]
    for i in range(cfg.num_layers):
        x = _block(layer(layers, i), x, cfg, dense)
    return _ln(params["final_ln"], x, cfg.layer_norm_eps)

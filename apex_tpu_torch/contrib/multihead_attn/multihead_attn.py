"""Multi-head attention modules over the port's kernels (counterpart of
``apex_tpu/contrib/multihead_attn/multihead_attn.py``; reference:
``apex/contrib/multihead_attn``'s ``SelfMultiheadAttn`` and
``EncdecMultiheadAttn``, impl ``'fast'``).

Each module is a packed input projection (qkv for self attention; q,
and kv from the encoder output, for encoder-decoder attention), the
attention through ``flash_attention`` (the flash forward, dq and dk/dv
kernels on the card, with their position-hash probability dropout), and
the output projection. ``include_norm_add`` adds the reference's
``*_norm_add`` variant: a LayerNorm of the input through
``fused_layer_norm_affine`` (the LayerNorm kernels on the card) and, at
the output, a dropout through ``utils.prng.bernoulli`` (the JAX
package's ``jax.random.bernoulli`` mask, bit for bit) followed by the
residual add. The projections are plain ``torch.matmul``, as they are
plain ``jnp.dot`` in the JAX package.

Conventions, as in the JAX package:

- tensors are sequence-first, ``(seq, batch, embed)``; the heads reach
  the kernels as views ``(batch, heads, seq, head_dim)`` with unit
  stride over head_dim;
- the packed projections are head-major (``[head0: q k v | head1: ...]``),
  so a column block holds whole heads;
- ``bias=False`` by default (the fast impl's default);
- ``key_padding_mask`` is (batch, src_len) with 1 = attend (the reference's
  byte mask marks pads: invert it when porting);
- ``apply`` returns the attention output only (the flash kernels never
  form the per-head weights).

``init(generator)`` draws N(0, 1/fan_in) kernels from a
``torch.Generator`` in the JAX ``init``'s order; JAX params cross with
``params_from_jax`` (re-exported here).
"""

import math
from typing import Any, Dict, Optional

import torch

from apex_tpu_torch.models._convert import params_from_jax  # noqa: F401
from apex_tpu_torch.normalization import fused_layer_norm_affine
from apex_tpu_torch.transformer.functional import flash_attention
from apex_tpu_torch.utils import prng
from apex_tpu_torch.utils.platform import DeviceLike, resolve_device


def _init_kernel(generator, shape, fan_in, dtype, dev):
    x = torch.randn(shape, generator=generator, dtype=dtype,
                    device=generator.device) * math.sqrt(1.0 / fan_in)
    return x.to(dev)


def _split_heads(x: torch.Tensor, nh: int) -> torch.Tensor:
    """(s, b, nh*hd) -> (b, nh, s, hd), a view."""
    s, b, w = x.shape
    return x.reshape(s, b, nh, w // nh).permute(1, 2, 0, 3)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    """(b, nh, s, hd) -> (s, b, nh*hd)."""
    b, nh, s, hd = x.shape
    return x.permute(2, 0, 1, 3).reshape(s, b, nh * hd)


def _output_dropout(x, rate, rng):
    """``x * bernoulli(rng, 1 - rate, x.shape) / (1 - rate)`` with the
    JAX package's mask; the divisor in x's dtype, as JAX takes a Python
    scalar."""
    if rng is None or rate <= 0:
        return x
    keep = prng.bernoulli(rng, 1 - rate, tuple(x.shape), device=x.device)
    return x * keep / torch.tensor(1 - rate, dtype=x.dtype)


class _MhaBase:
    def __init__(self, embed_dim: int, num_heads: int, *,
                 dropout: float = 0.0, bias: bool = False,
                 include_norm_add: bool = False,
                 params_dtype=torch.float32):
        if embed_dim % num_heads:
            raise ValueError(
                f"embed_dim {embed_dim} not divisible by num_heads "
                f"{num_heads}")
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.dropout = dropout
        self.use_bias = bias
        self.include_norm_add = include_norm_add
        self.params_dtype = params_dtype
        self.scaling = self.head_dim ** -0.5

    def _kernels(self, generator, shapes, device):
        dev = resolve_device(device)
        h = self.embed_dim
        p = {name: {"kernel": _init_kernel(generator, shape, h,
                                           self.params_dtype, dev)}
             for name, shape in shapes}
        if self.use_bias:
            for name, shape in shapes:
                p[name]["bias"] = torch.zeros((shape[1],),
                                              dtype=self.params_dtype,
                                              device=dev)
        if self.include_norm_add:
            p["layernorm"] = {
                "weight": torch.ones((h,), dtype=torch.float32, device=dev),
                "bias": torch.zeros((h,), dtype=torch.float32, device=dev)}
        return p

    def _maybe_norm(self, params, x):
        if not self.include_norm_add:
            return x
        p = params["layernorm"]
        return fused_layer_norm_affine(x, p["weight"], p["bias"],
                                       self.embed_dim, 1e-5).to(x.dtype)

    def _proj(self, p, x):
        y = torch.matmul(x, p["kernel"].to(x.dtype))
        if "bias" in p:
            y = y + p["bias"].to(y.dtype)
        return y

    def _attend(self, q, k, v, key_padding_mask, attn_mask_causal,
                dropout_rng, is_training):
        rate = self.dropout if (is_training and dropout_rng is not None) \
            else 0.0
        rng = dropout_rng if rate > 0 else None
        return flash_attention(q, k, v, key_padding_mask,
                               causal=attn_mask_causal,
                               softmax_scale=self.scaling,
                               dropout_rate=rate, dropout_rng=rng)

    def _epilogue(self, out, query, rng, is_training):
        """The norm-add variant's output: dropout(out) + the residual."""
        if not self.include_norm_add:
            return out
        if is_training:
            out = _output_dropout(out, self.dropout, rng)
        return out + query


class SelfMultiheadAttn(_MhaBase):
    """Self attention with one packed qkv projection (ref:
    ``SelfMultiheadAttn(impl='fast')``, ``*_norm_add`` with
    ``include_norm_add=True``)."""

    def init(self, generator: torch.Generator,
             device: DeviceLike = None) -> Dict[str, Any]:
        h = self.embed_dim
        return self._kernels(generator, (("qkv", (h, 3 * h)),
                                         ("out", (h, h))), device)

    def apply(self, params: Dict[str, Any], query: torch.Tensor, *,
              key_padding_mask: Optional[torch.Tensor] = None,
              attn_mask_causal: bool = False,
              is_training: bool = True,
              dropout_rng=None) -> torch.Tensor:
        """query: (tgt_len, batch, embed) -> the same shape."""
        x = self._maybe_norm(params, query)
        qkv = self._proj(params["qkv"], x)       # (s, b, 3h) head-major
        s, b, _ = qkv.shape
        nh, hd = self.num_heads, self.head_dim
        qkv = qkv.reshape(s, b, nh, 3, hd)
        q, k, v = (qkv[:, :, :, j].permute(1, 2, 0, 3) for j in range(3))
        rngs = (prng.split(dropout_rng) if dropout_rng is not None
                else (None, None))
        ctx = self._attend(q, k, v, key_padding_mask, attn_mask_causal,
                           rngs[0], is_training)
        out = self._proj(params["out"], _merge_heads(ctx))
        return self._epilogue(out, query, rngs[1], is_training)

    __call__ = apply


class EncdecMultiheadAttn(_MhaBase):
    """Encoder-decoder attention: q from the decoder's query, packed kv
    from the encoder output (ref: ``EncdecMultiheadAttn(impl='fast')``)."""

    def init(self, generator: torch.Generator,
             device: DeviceLike = None) -> Dict[str, Any]:
        h = self.embed_dim
        return self._kernels(generator, (("q", (h, h)), ("kv", (h, 2 * h)),
                                         ("out", (h, h))), device)

    def apply(self, params: Dict[str, Any], query: torch.Tensor,
              key: torch.Tensor, *,
              key_padding_mask: Optional[torch.Tensor] = None,
              attn_mask_causal: bool = False,
              is_training: bool = True,
              dropout_rng=None) -> torch.Tensor:
        """query: (tgt_len, b, h); key: (src_len, b, h), the encoder
        output, both the keys' and the values' input."""
        x = self._maybe_norm(params, query)
        nh, hd = self.num_heads, self.head_dim
        q = _split_heads(self._proj(params["q"], x), nh)
        kv = self._proj(params["kv"], key)       # (s_k, b, 2h) head-major
        sk, b, _ = kv.shape
        kv = kv.reshape(sk, b, nh, 2, hd)
        k_, v_ = (kv[:, :, :, j].permute(1, 2, 0, 3) for j in range(2))
        rngs = (prng.split(dropout_rng) if dropout_rng is not None
                else (None, None))
        ctx = self._attend(q, k_, v_, key_padding_mask, attn_mask_causal,
                           rngs[0], is_training)
        out = self._proj(params["out"], _merge_heads(ctx))
        return self._epilogue(out, query, rngs[1], is_training)

    __call__ = apply

"""BERT encoder with the masked-LM head (counterpart of
``apex_tpu/models/bert.py``), the north-star model: every LayerNorm
through ``fused_layer_norm_affine``, attention through
``flash_attention`` (``fused_attention=True``) or through the score
product, ``scaled_masked_softmax`` and the context product
(``fused_attention=False``), the MLM loss through the fused softmax
cross entropy. The dense products, embeddings and activations are plain
PyTorch, as they are plain ``jnp`` in the JAX package. Under O1
(``amp.autocast``) the dense products and the unfused branch's two
attention products take the compute dtype through the op policy, as
the JAX package's ``cast_args`` sites do; outside it they are the
products as given.

The param tree has the JAX tree's keys, dtypes and layout, the encoder
a list of per-layer dicts, so the O2 cast keeps every ``layernorm``
leaf fp32 as in JAX.

Dropout follows the JAX package key for key: ``dropout_rng`` splits
into 2L + 1 keys (the embeddings', then per layer the attention's and
the hidden one's), the hidden dropout and the unfused branch's
probability dropout go through ``utils.prng.dropout`` (the threefry
kernel on the card; its backward regenerates each mask from its key),
and the flash branch hands its key to ``flash_attention``. ``remat``
recomputes each encoder layer in the backward
(``torch.utils.checkpoint``) with the same keys, so it gives the same
numbers; the recompute re-enters the autocast context of the forward
(the backward may run on another thread, whose context is its own).
"""

import dataclasses
import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from apex_tpu_torch.amp.autocast import autocast, autocast_dtype, cast_args
from apex_tpu_torch.contrib.xentropy import softmax_cross_entropy_loss
from apex_tpu_torch.models import layers as L
from apex_tpu_torch.normalization import fused_layer_norm_affine
from apex_tpu_torch.transformer.functional import (
    flash_attention, scaled_masked_softmax,
)
from apex_tpu_torch.utils import prng
from apex_tpu_torch.utils.platform import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    intermediate_size: int = 4096
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    hidden_dropout: float = 0.1     # applied only when rng given
    attention_dropout: float = 0.1
    fused_attention: bool = True
    remat: bool = False

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


def bert_large() -> BertConfig:
    return BertConfig()


def bert_base() -> BertConfig:
    return BertConfig(hidden_size=768, num_layers=12, num_heads=12,
                      intermediate_size=3072)


def bert_tiny() -> BertConfig:  # for tests
    return BertConfig(vocab_size=1024, hidden_size=128, num_layers=2,
                      num_heads=4, intermediate_size=256,
                      max_position_embeddings=128)


def init_bert(cfg: BertConfig, generator: torch.Generator,
              dtype: torch.dtype = torch.float32,
              device: DeviceLike = None) -> Dict[str, Any]:
    """Random params with the JAX ``init_bert`` tree and distributions:
    dense kernels and embeddings truncated N(0, 0.02^2), zero biases,
    fp32 LayerNorm weight 1 and bias 0. Drawn on ``generator``'s device,
    then moved to ``device``."""
    dev = resolve_device(device)
    h, i = cfg.hidden_size, cfg.intermediate_size
    kw = dict(dtype=dtype, device=dev)

    def ln():
        return {"weight": torch.ones((h,), device=dev),
                "bias": torch.zeros((h,), device=dev)}

    params: Dict[str, Any] = {
        "embeddings": {
            "word": L.init_embedding(generator, cfg.vocab_size, h, **kw),
            "position": L.init_embedding(
                generator, cfg.max_position_embeddings, h, **kw),
            "token_type": L.init_embedding(
                generator, cfg.type_vocab_size, h, **kw),
            "layernorm": ln(),
        },
        "encoder": [],
        "mlm_head": {
            "transform": L.init_dense(generator, h, h, **kw),
            "layernorm": ln(),
            # the decoder ties to the word embedding; only a bias is stored
            "bias": torch.zeros((cfg.vocab_size,), **kw),
        },
        "pooler": L.init_dense(generator, h, h, **kw),
    }
    for _ in range(cfg.num_layers):
        params["encoder"].append({
            "attention": {
                "qkv": L.init_dense(generator, h, 3 * h, **kw),
                "out": L.init_dense(generator, h, h, **kw),
                "layernorm": ln(),
            },
            "mlp": {
                "fc1": L.init_dense(generator, h, i, **kw),
                "fc2": L.init_dense(generator, i, h, **kw),
                "layernorm": ln(),
            },
        })
    return params


def _ln(p, x, eps):
    return fused_layer_norm_affine(x, p["weight"], p["bias"], x.shape[-1],
                                   eps).to(x.dtype)


def _gelu(x):
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


def _attention(p, cfg: BertConfig, x, mask, dropout_rng=None):
    b, s, h = x.shape
    nh, hd = cfg.num_heads, cfg.head_dim
    # the fused projection is laid out (3, nh, hd): q, k, v are strided
    # views of it, which the kernels read as they are
    qkv = L.dense(p["qkv"], x).reshape(b, s, 3, nh, hd)
    q, k, v = (qkv[:, :, j].transpose(1, 2) for j in range(3))
    if cfg.fused_attention:
        ctx = flash_attention(q, k, v, mask,
                              softmax_scale=1.0 / math.sqrt(hd),
                              dropout_rate=cfg.attention_dropout,
                              dropout_rng=dropout_rng)
    else:
        # the unfused path: plain products in the compute dtype around the
        # fused softmax, whose mask is nonzero where a key is padding
        scores = torch.matmul(*cast_args("einsum", q, k.transpose(-1, -2)))
        if mask is not None:
            inv = (1 - mask)[:, None, None, :]
        else:
            inv = torch.zeros((b, 1, 1, s), dtype=torch.int32,
                              device=x.device)
        probs = scaled_masked_softmax(scores, inv, 1.0 / math.sqrt(hd))
        probs = _maybe_dropout(probs, cfg.attention_dropout, dropout_rng)
        ctx = torch.matmul(*cast_args("einsum", probs, v))
    ctx = ctx.transpose(1, 2).reshape(b, s, h)
    return L.dense(p["out"], ctx)


def _maybe_dropout(x, rate, rng):
    if rng is None or rate <= 0:
        return x
    return prng.dropout(rng, x, rate)


def apply_bert(params: Dict[str, Any], cfg: BertConfig,
               input_ids: torch.Tensor,
               attention_mask: Optional[torch.Tensor] = None,
               token_type_ids: Optional[torch.Tensor] = None, *,
               dropout_rng=None,
               compute_dtype: Optional[torch.dtype] = None
               ) -> Dict[str, torch.Tensor]:
    """Returns {"hidden": (b, s, h), "mlm_logits": (b, s, vocab) fp32,
    "pooled": (b, h)}. ``dropout_rng`` (a ``utils.prng`` key) turns on
    the hidden and attention dropout; ``compute_dtype`` casts the
    embedding tables before the lookups, as in JAX."""
    s = input_ids.shape[1]
    emb = params["embeddings"]
    x = L.embedding(emb["word"], input_ids, compute_dtype)
    x = x + L.embedding(emb["position"],
                        torch.arange(s, device=input_ids.device),
                        compute_dtype)[None]
    if token_type_ids is None:
        token_type_ids = torch.zeros_like(input_ids)
    x = x + L.embedding(emb["token_type"], token_type_ids, compute_dtype)
    x = _ln(emb["layernorm"], x, cfg.layer_norm_eps)

    n_keys = 2 * cfg.num_layers + 1
    rngs = (prng.split(dropout_rng, n_keys) if dropout_rng is not None
            else [None] * n_keys)
    x = _maybe_dropout(x, cfg.hidden_dropout, rngs[0])

    def encoder_layer(layer, x, rng_a, rng_h):
        att = _attention(layer["attention"], cfg, x, attention_mask, rng_a)
        att = _maybe_dropout(att, cfg.hidden_dropout, rng_h)
        x = _ln(layer["attention"]["layernorm"], x + att, cfg.layer_norm_eps)
        mlp = L.dense(layer["mlp"]["fc2"],
                      _gelu(L.dense(layer["mlp"]["fc1"], x)))
        return _ln(layer["mlp"]["layernorm"], x + mlp, cfg.layer_norm_eps)

    if cfg.remat:
        ac = autocast_dtype()
        plain_layer = encoder_layer

        def encoder_layer(*args):
            with autocast(ac, enabled=ac is not None):
                return plain_layer(*args)

    for li, layer in enumerate(params["encoder"]):
        args = (layer, x, rngs[2 * li + 1], rngs[2 * li + 2])
        x = (checkpoint(encoder_layer, *args, use_reentrant=False)
             if cfg.remat else encoder_layer(*args))

    head = params["mlm_head"]
    t = _gelu(L.dense(head["transform"], x))
    t = _ln(head["layernorm"], t, cfg.layer_norm_eps)
    word_table = emb["word"]["embedding"].to(t.dtype)
    mlm_logits = (torch.matmul(t, word_table.t()).float()
                  + head["bias"].float())
    pooled = torch.tanh(L.dense(params["pooler"], x[:, 0]))
    return {"hidden": x, "mlm_logits": mlm_logits, "pooled": pooled}


def mlm_loss(logits: torch.Tensor, labels: torch.Tensor,
             label_mask: torch.Tensor) -> torch.Tensor:
    """Masked-LM cross entropy in fp32; ``label_mask`` (1 = predict)
    selects positions. Through the fused softmax cross entropy, so the
    (b, s, vocab) log-softmax is never materialised."""
    b, s, v = logits.shape
    flat_labels = torch.where(label_mask != 0, labels,
                              torch.full_like(labels, -1)).reshape(b * s)
    losses = softmax_cross_entropy_loss(logits.reshape(b * s, v),
                                        flat_labels)
    m = label_mask.float()
    return losses.sum() / torch.clamp(m.sum(), min=1.0)


def bert_partition_specs(params: Dict[str, Any]):
    """Megatron PartitionSpecs for a BERT param tree over the mesh axes
    (``parallel_state.PartitionSpec``): qkv / fc1 split by columns, the
    attention output / fc2 by rows, the word table by vocabulary; the
    rest replicated."""
    from apex_tpu_torch.transformer import parallel_state as ps

    P = ps.PartitionSpec
    tp = ps.TENSOR_AXIS

    def spec_for(keys) -> P:
        joined = "/".join(keys)
        name = keys[-1]
        if "layernorm" in joined or name == "bias" and "mlm_head" in joined:
            return P()
        if "word" in joined and name == "embedding":
            return P(tp, None)          # vocabulary-split
        if name == "embedding":
            return P()                   # position / token-type
        if "qkv" in joined or "fc1" in joined:
            return P(None, tp) if name == "kernel" else P(tp)
        if ("attention/out" in joined or "fc2" in joined) and name == "kernel":
            return P(tp, None)           # row-parallel
        return P()

    def walk(tree, keys):
        if isinstance(tree, dict):
            return {k: walk(v, keys + (str(k),)) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(walk(v, keys + (str(i),))
                              for i, v in enumerate(tree))
        return spec_for(keys)

    return walk(params, ())

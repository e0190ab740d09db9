"""GPT (decoder-only transformer), the single-device subset of
``apex_tpu/models/gpt.py``: inference (the serving blocks) and training
(``apply_gpt_unsharded`` with dropout, ``gpt_loss_unsharded``).

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
rotary (``use_rope``). The tensor-, sequence- and context-parallel
paths (``GPTModel`` and its fields) and the paged, verify and tree
blocks are later slices. Weight-only int8 trees run the serving blocks
with ``serving/decode.py``'s w8 linears.
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

from apex_tpu_torch.contrib.xentropy import softmax_cross_entropy_loss
from apex_tpu_torch.models._convert import params_from_jax  # noqa: F401
from apex_tpu_torch.normalization import fused_layer_norm_affine
from apex_tpu_torch.transformer.functional import (
    flash_attention, fused_apply_rotary_pos_emb_bhsd, rope_frequencies,
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
    # the tensor-, sequence- and context-parallel fields: ROADMAP A6;
    # check_config raises when one is set
    sequence_parallel: bool = False
    context_parallel: bool = False
    context_parallel_impl: str = "ring"
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


_PARALLEL_FIELDS = {"sequence_parallel": False, "context_parallel": False,
                    "context_parallel_impl": "ring",
                    "gradient_accumulation_fusion": False}


def check_config(cfg: GPTConfig) -> None:
    """The tensor-, sequence- and context-parallel fields are not ported
    (ROADMAP A6): a config that sets one raises."""
    for name, off in _PARALLEL_FIELDS.items():
        if getattr(cfg, name) != off:
            raise NotImplementedError(
                f"GPTConfig.{name}={getattr(cfg, name)!r} is not ported "
                "yet (ROADMAP queue A6: data and model parallelism); the "
                f"port runs one device with {name}={off!r}")


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


def _gelu(x):
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


def _mlp(lp, x, cfg, dense):
    return dense(lp["fc2"], _gelu(dense(lp["fc1"], _ln(
        lp["ln2"], x, cfg.layer_norm_eps))))


def _maybe_dropout(x, rate, rng, salt):
    """``x * bernoulli(fold_in(rng, salt), 1 - rate) / (1 - rate)`` as
    the JAX package's GPT writes it, through the fused threefry
    dropout."""
    if rng is None or rate <= 0:
        return x
    return prng.dropout(prng.fold_in(rng, salt), x, rate)


def _block(lp, x, cfg, rope_freqs, dense, dropout_rng=None):
    """Pre-LN transformer block: x + Attn(LN(x)); x + MLP(LN(x)), the
    hidden dropout after the attention's output projection (salt 0)
    and after fc2 (salt 1)."""
    att = _causal_attention(dense(lp["qkv"], _ln(lp["ln1"], x,
                                                 cfg.layer_norm_eps)),
                            cfg, rope_freqs)
    att = _maybe_dropout(dense(lp["out"], att), cfg.hidden_dropout,
                         dropout_rng, 0)
    x = x + att
    mlp = _maybe_dropout(_mlp(lp, x, cfg, dense), cfg.hidden_dropout,
                         dropout_rng, 1)
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
    """Single-query attention against one layer's per-slot cache.

    ``q_k_v`` (b, 1, 3*h); ``k_cache``/``v_cache`` (b, nh, S_max, hd),
    written IN PLACE; ``pos`` (b,) each slot's current length, the new
    token's absolute position (RoPE rotates q and k there). The new k/v
    row is written at ``pos`` (clamped to the last row, as the JAX
    ``dynamic_update_slice`` clamps) BEFORE attending, so the ``s <=
    pos`` mask only admits rows that hold real tokens. Scores and
    softmax in fp32; returns ctx (b, 1, h)."""
    b = q_k_v.shape[0]
    hd = cfg.head_dim
    q, k, v = _split_qkv(q_k_v, hd)            # (b, nh, 1, hd)
    q, k = _rotate(q, k, rope_freqs, positions=pos)
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


def _block_prefill(lp, x, cfg, rope_freqs, key_mask, dense):
    """:func:`_block` (no dropout) that also returns this layer's (k, v)
    tiles."""
    att, k, v = _prefill_attention(
        dense(lp["qkv"], _ln(lp["ln1"], x, cfg.layer_norm_eps)), cfg,
        rope_freqs, key_mask)
    x = x + dense(lp["out"], att)
    return x + _mlp(lp, x, cfg, dense), k, v


def _block_decode(lp, x, k_cache, v_cache, pos, cfg, rope_freqs, dense):
    """:func:`_block` against one layer's cache (updated in place): x is
    the (b, 1, h) new-token hidden."""
    att = _decode_attention(
        dense(lp["qkv"], _ln(lp["ln1"], x, cfg.layer_norm_eps)), k_cache,
        v_cache, pos, cfg, rope_freqs)
    x = x + dense(lp["out"], att)
    return x + _mlp(lp, x, cfg, dense)


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


def _scan_layers(x, layers, cfg, freqs, dense_fn, dropout_rng):
    """Depth loop over the stacked layer leaves, each layer checkpointed
    under ``cfg.remat``; with a key, layer i draws on
    ``split(dropout_rng, num_layers)[i]``."""
    def block(lp, x, rng):
        return _block(lp, x, cfg, freqs, dense_fn, dropout_rng=rng)

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
    x = _scan_layers(x, params["layers"], cfg, freqs, dense, dropout_rng)
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
    # The JAX package passes the product through amp's cast_args, which
    # casts only under O1 (amp.autocast, ROADMAP A5); elsewhere it is
    # the identity, as here.
    logits = torch.matmul(hidden, table.to(hidden.dtype).t())
    v = logits.shape[-1]
    nll = softmax_cross_entropy_loss(logits.reshape(-1, v),
                                     labels.reshape(-1))
    return nll.mean()


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

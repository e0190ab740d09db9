"""Dense KV cache (counterpart of ``apex_tpu/serving/cache.py``).

Layout: ``k``/``v`` are ``(num_layers, num_slots, num_heads, S_max,
head_dim)``; ``lengths`` ``(num_slots,)`` int32 is each slot's count of
real positions — the next write offset and the attention-mask bound.
The prefill and decode steps update these tensors IN PLACE (the
counterpart of the JAX package's donated cache). bf16 halves the bytes;
fp32 is for parity tests. The paged cache is a later slice.
"""

from typing import NamedTuple

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

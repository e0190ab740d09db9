"""Token sampling (counterpart of ``apex_tpu/serving/sampling.py``),
greedy rows only.

Sampled rows (``temperature > 0``) need the JAX package's exact
random streams — threefry2x32, ``fold_in`` and ``categorical`` — to
stay identical to the reference scheduler; until those are ported,
such a row raises.
"""

import torch

_SAMPLED = ("sampling with temperature > 0 is not ported yet: identical "
            "sampled streams need threefry2x32, fold_in and categorical "
            "in torch (ROADMAP queue A, deferred serving pieces: sampled "
            "streams)")


def sample_tokens(logits: torch.Tensor,
                  temperature: torch.Tensor) -> torch.Tensor:
    """logits (B, V) fp32; temperature (B,) — ``t <= 0`` means greedy
    for that slot. Returns (B,) int32 argmax ids (first maximum on
    ties, as ``jnp.argmax``)."""
    if bool((temperature > 0).any()):
        raise NotImplementedError(_SAMPLED)
    return torch.argmax(logits, dim=-1).to(torch.int32)


def finite_rows(logits: torch.Tensor) -> torch.Tensor:
    """(..., V) -> (...,) bool: True where a row is entirely finite —
    the gate that keeps a NaN/Inf row from ever being sampled."""
    return torch.isfinite(logits).all(dim=-1)

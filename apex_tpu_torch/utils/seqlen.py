"""Variable-sequence-length support via bucketing (counterpart of
``apex_tpu/utils/seqlen.py``).

Prompts are padded to one of a small ladder of lengths, so the prefill
works at a few shapes only and the padding fraction is bounded by the
ladder's ratio. The mask marks the real positions.
"""

from typing import Optional, Sequence, Tuple

import torch

_DEFAULT_MIN = 128


def default_buckets(max_len: int, min_len: int = _DEFAULT_MIN
                    ) -> Tuple[int, ...]:
    """Power-of-two ladder ``min_len, 2*min_len, ... >= max_len``."""
    if max_len < 1:
        raise ValueError("max_len must be positive")
    out = []
    b = min_len
    while b < max_len:
        out.append(b)
        b *= 2
    out.append(b)
    return tuple(out)


def bucket_for(length: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= length (raises if none fits)."""
    for b in sorted(buckets):
        if length <= b:
            return int(b)
    raise ValueError(
        f"sequence length {length} exceeds the largest bucket "
        f"{max(buckets)}; truncate upstream or extend the buckets")


def pad_to_bucket(x: torch.Tensor, length: int, *, seq_axis: int = 1,
                  buckets: Optional[Sequence[int]] = None,
                  pad_value=0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pad ``x`` along ``seq_axis`` from ``length`` to its bucket;
    returns ``(padded, mask)`` where ``mask`` is ``(bucket,)`` int32 on
    ``x``'s device with 1 = real position."""
    if buckets is None:
        buckets = default_buckets(length)
    target = bucket_for(length, buckets)
    if x.shape[seq_axis] != length:
        raise ValueError(
            f"tensor has seq length {x.shape[seq_axis]}, expected "
            f"{length}")
    if target != length:
        shape = list(x.shape)
        shape[seq_axis] = target - length
        x = torch.cat([x, x.new_full(shape, pad_value)], dim=seq_axis)
    mask = (torch.arange(target, device=x.device) < length).to(
        torch.int32)
    return x, mask

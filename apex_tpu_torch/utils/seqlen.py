"""Variable-sequence-length support via bucketing (counterpart of
``apex_tpu/utils/seqlen.py``).

Prompts are padded to one of a small ladder of lengths, so the prefill
works at a few shapes only and the padding fraction is bounded by the
ladder's ratio. The mask marks the real positions.
"""

from typing import Any, Optional, Sequence, Tuple

import torch

from apex_tpu_torch.utils.tree import tree_leaves, tree_map

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


def pad_to_bucket(batch: Any, length: int, *, seq_axis: int = 1,
                  buckets: Optional[Sequence[int]] = None,
                  pad_value=0) -> Tuple[Any, torch.Tensor]:
    """Pad every leaf of ``batch`` (a tensor, or a dict/list/tuple tree
    of them: ids, mask, labels) along ``seq_axis`` from ``length`` to its
    bucket; returns ``(padded_batch, mask)`` where ``mask`` is
    ``(bucket,)`` int32 with 1 = real position, on the first leaf's
    device. ``length`` is the current length; a leaf of another length
    raises ``ValueError``. Call it in the data loader."""
    if buckets is None:
        buckets = default_buckets(length)
    target = bucket_for(length, buckets)

    def pad(x):
        x = torch.as_tensor(x)
        if x.shape[seq_axis] != length:
            raise ValueError(
                f"leaf has seq length {x.shape[seq_axis]}, expected "
                f"{length}")
        if target == length:
            return x
        shape = list(x.shape)
        shape[seq_axis] = target - length
        return torch.cat([x, x.new_full(shape, pad_value)], dim=seq_axis)

    padded = tree_map(pad, batch)
    leaves = tree_leaves(padded)
    dev = leaves[0].device if leaves else torch.device("cpu")
    mask = (torch.arange(target, device=dev) < length).to(torch.int32)
    return padded, mask

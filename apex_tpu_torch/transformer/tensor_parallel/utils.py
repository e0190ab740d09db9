"""Shard-math helpers (counterpart of
``apex_tpu/transformer/tensor_parallel/utils.py``; reference:
``apex/transformer/tensor_parallel/utils.py``)."""

from typing import Tuple

from apex_tpu_torch.utils.math import divide


def split_tensor_along_last_dim(tensor, num_partitions: int,
                                contiguous_split_chunks: bool = False):
    """``num_partitions`` equal blocks of the last dimension (views;
    contiguous copies with ``contiguous_split_chunks``)."""
    size = divide(tensor.shape[-1], num_partitions)
    parts = list(tensor.split(size, dim=-1))
    if contiguous_split_chunks:
        return [p.contiguous() for p in parts]
    return parts


class VocabUtility:
    """Vocab range bookkeeping (ref: ``class VocabUtility``)."""

    @staticmethod
    def vocab_range_from_per_partition_vocab_size(
            per_partition_vocab_size: int, rank: int,
            world_size: int) -> Tuple[int, int]:
        f = rank * per_partition_vocab_size
        return f, f + per_partition_vocab_size

    @staticmethod
    def vocab_range_from_global_vocab_size(global_vocab_size: int, rank: int,
                                           world_size: int) -> Tuple[int, int]:
        per = divide(global_vocab_size, world_size)
        return VocabUtility.vocab_range_from_per_partition_vocab_size(
            per, rank, world_size)

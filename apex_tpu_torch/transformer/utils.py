"""Transformer-layer utilities (counterpart of
``apex_tpu/transformer/utils.py``; reference: ``apex/transformer/utils.py``
: ``divide``, ``ensure_divisibility``, ``split_tensor_along_last_dim``)."""

import torch

from apex_tpu_torch.utils.math import divide, ensure_divisibility  # noqa: F401


def split_tensor_along_last_dim(tensor: torch.Tensor, num_partitions: int):
    """Split a tensor along its last dimension into equal partitions: a
    tuple of views (the JAX package drops the reference's
    ``contiguous_split_chunks`` flag, and so does the port)."""
    size = divide(tensor.shape[-1], num_partitions)
    return tuple(torch.split(tensor, size, dim=-1))

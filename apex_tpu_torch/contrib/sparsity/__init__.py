"""Automatic structured sparsity (counterpart of
``apex_tpu/contrib/sparsity``)."""

from apex_tpu_torch.contrib.sparsity.asp import (  # noqa: F401
    ASP,
    apply_masks,
    compute_sparse_masks,
    m4n2_1d_mask,
)

"""Fused dense blocks (counterpart of ``apex_tpu/fused_dense``)."""

from apex_tpu_torch.fused_dense.fused_dense import (  # noqa: F401
    FusedDense,
    FusedDenseGeluDense,
)

"""Transformer building blocks (the functional attention paths)."""
from apex_tpu_torch.transformer.functional.flash_attention import (  # noqa: F401
    flash_attention,
)
from apex_tpu_torch.transformer.functional.fused_softmax import (  # noqa: F401
    FusedScaleMaskSoftmax, scaled_masked_softmax,
    scaled_upper_triang_masked_softmax,
)

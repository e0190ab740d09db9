"""Module-level fused multi-head attention (counterpart of
``apex_tpu/contrib/multihead_attn``; reference:
``apex/contrib/multihead_attn``)."""

from apex_tpu_torch.contrib.multihead_attn.multihead_attn import (  # noqa: F401
    EncdecMultiheadAttn,
    SelfMultiheadAttn,
)

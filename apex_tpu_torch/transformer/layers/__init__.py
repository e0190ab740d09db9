"""LayerNorm re-export (counterpart of ``apex_tpu/transformer/layers``;
reference: ``apex/transformer/layers/layer_norm.py``, which bridges to
``fast_layer_norm`` where the hidden size has a persistent kernel, else
to ``fused_layer_norm``). The port has one LayerNorm kernel for any
width, so both names resolve to it."""

from apex_tpu_torch.normalization import (  # noqa: F401
    FusedLayerNorm,
    FusedRMSNorm,
    MixedFusedLayerNorm,
    MixedFusedRMSNorm,
)

# the reference's persistent-kernel alias
FastLayerNorm = FusedLayerNorm

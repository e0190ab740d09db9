"""Quantized inference: weight-only int8 trees and the dequant-fused
int8 matmuls (counterpart of ``apex_tpu/quant``).

``quantize_params`` builds the weight-only int8 tree (per-output-channel
symmetric fp32 scales); ``w8_matmul``/``w8_matmul_nk`` are the
hand-written dequant-fused matmuls the serving steps plug in for a
quantized tree. The int8 paged KV codecs and the partition specs are
later slices."""

from apex_tpu_torch.quant.kernels import (  # noqa: F401
    w8_limit,
    w8_matmul,
    w8_matmul_nk,
)
from apex_tpu_torch.quant.params import (  # noqa: F401
    dequantize_tensor,
    is_quantized_tree,
    quantize_params,
    quantize_tensor,
)

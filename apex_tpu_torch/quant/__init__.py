"""Quantized inference: weight-only int8 trees and the dequant-fused
int8 matmuls (counterpart of ``apex_tpu/quant``).

``quantize_params`` builds the weight-only int8 tree (per-output-channel
symmetric fp32 scales); ``w8_matmul``/``w8_matmul_nk`` are the
hand-written dequant-fused matmuls the serving steps plug in for a
quantized tree; ``kv_quantize``/``kv_dequantize`` are the int8 paged
KV pool's codecs. The partition specs are a later slice."""

from apex_tpu_torch.quant.kernels import (  # noqa: F401
    kv_dequantize,
    kv_quantize,
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

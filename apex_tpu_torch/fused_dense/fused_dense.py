"""Fused dense blocks (counterpart of
``apex_tpu/fused_dense/fused_dense.py``): linear + bias, and linear ->
GELU -> linear with the exact (erf) GELU the reference kernel computes.

The reference fuses them into GEMM epilogues with ``fused_dense_cuda``;
the JAX package leaves them to XLA and has no Pallas kernel for them,
and here they are plain PyTorch products and ``F.gelu(approximate=
"none")``. Each product passes its operands through the O1 op policy
(``cast_args("dense", ...)``), so inside ``amp.autocast`` it runs in
the compute dtype and the bias follows the product's dtype.
"""

from typing import Any, Dict

import torch
import torch.nn.functional as F

from apex_tpu_torch.amp.autocast import cast_args
from apex_tpu_torch.mlp.mlp import _uniform_init
from apex_tpu_torch.utils.platform import DeviceLike, resolve_device


def _dense(p, x):
    x, kernel = cast_args("dense", x, p["kernel"])
    y = torch.matmul(x, kernel.to(x.dtype))
    if "bias" in p:
        y = y + p["bias"].to(y.dtype)
    return y


def _layer(generator, fi, fo, bias, dtype, device) -> Dict[str, Any]:
    p = {"kernel": _uniform_init(generator, fi, (fi, fo), dtype, device)}
    if bias:
        p["bias"] = torch.zeros((fo,), dtype=dtype,
                                device=resolve_device(device))
    return p


class FusedDense:
    """Linear + bias (the reference's ``FusedDense``)."""

    def __init__(self, in_features: int, out_features: int, *,
                 bias: bool = True,
                 params_dtype: torch.dtype = torch.float32):
        self.in_features = in_features
        self.out_features = out_features
        self.use_bias = bias
        self.params_dtype = params_dtype

    def init(self, generator: torch.Generator,
             device: DeviceLike = None) -> Dict[str, Any]:
        return _layer(generator, self.in_features, self.out_features,
                      self.use_bias, self.params_dtype, device)

    def apply(self, params: Dict[str, Any], x: torch.Tensor
              ) -> torch.Tensor:
        return _dense(params, x)

    __call__ = apply


class FusedDenseGeluDense:
    """Linear -> GELU (exact) -> linear (the reference's
    ``FusedDenseGeluDense``)."""

    def __init__(self, in_features: int, intermediate_features: int,
                 out_features: int, *, bias: bool = True,
                 params_dtype: torch.dtype = torch.float32):
        self.in_features = in_features
        self.intermediate_features = intermediate_features
        self.out_features = out_features
        self.use_bias = bias
        self.params_dtype = params_dtype

    def init(self, generator: torch.Generator,
             device: DeviceLike = None) -> Dict[str, Any]:
        dims = (self.in_features, self.intermediate_features,
                self.out_features)
        return {name: _layer(generator, fi, fo, self.use_bias,
                             self.params_dtype, device)
                for name, fi, fo in (("fc1", dims[0], dims[1]),
                                     ("fc2", dims[1], dims[2]))}

    def apply(self, params: Dict[str, Any], x: torch.Tensor
              ) -> torch.Tensor:
        h = F.gelu(_dense(params["fc1"], x), approximate="none")
        return _dense(params["fc2"], h)

    __call__ = apply

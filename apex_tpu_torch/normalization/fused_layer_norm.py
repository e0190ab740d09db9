"""Fused LayerNorm / RMSNorm forward (counterpart of
``apex_tpu/normalization/fused_layer_norm.py``).

Contract, as in the JAX package: statistics and all arithmetic in fp32,
output in the input dtype; weight and bias may each be fp32 or bf16
(O2 casts every GPT leaf to bf16, norms included). The forward also
yields the fp32 mean (LN only) and rstd the backward will consume.

Dispatch: a CUDA tensor launches the hand-written kernel
(``csrc/layer_norm.cu``) or raises; a CPU tensor takes the plain
PyTorch version below. The backward kernel is a later slice: the
autograd backward raises rather than falling back to plain autograd.
"""

import ctypes
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from apex_tpu_torch.utils.cuda_build import CudaLibrary, Kernel
from apex_tpu_torch.utils.platform import on_card

Shape = Union[int, Sequence[int]]

LIB = CudaLibrary("layer_norm")
_P = ctypes.c_void_p
_I = ctypes.c_int
LN_FWD = Kernel(LIB, "apx_layer_norm_fwd",
                [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                 ctypes.c_float, _P])
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _normalized_size(normalized_shape: Shape) -> int:
    if isinstance(normalized_shape, int):
        return normalized_shape
    return int(np.prod(tuple(normalized_shape)))


def layer_norm_fwd_plain(x2d: torch.Tensor, w: Optional[torch.Tensor],
                         b: Optional[torch.Tensor], mode: str, eps: float
                         ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                                    torch.Tensor]:
    """Plain PyTorch version of the kernel: (y, mean or None, rstd),
    mean/rstd (rows, 1) fp32."""
    x = x2d.float()
    if mode == "ln":
        mean = x.mean(dim=1, keepdim=True)
        xc = x - mean
        rstd = torch.rsqrt((xc * xc).mean(dim=1, keepdim=True) + eps)
        xhat = xc * rstd
    else:
        mean = None
        rstd = torch.rsqrt((x * x).mean(dim=1, keepdim=True) + eps)
        xhat = x * rstd
    y = xhat
    if w is not None:
        y = y * w.float()
    if b is not None:
        y = y + b.float()
    return y.to(x2d.dtype), mean, rstd


def layer_norm_fwd_kernel(x2d: torch.Tensor, w: Optional[torch.Tensor],
                          b: Optional[torch.Tensor], mode: str, eps: float
                          ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                                     torch.Tensor]:
    """Launch ``csrc/layer_norm.cu`` on CUDA tensors; raises on anything
    the kernel does not take."""
    if x2d.device.type != "cuda":
        raise RuntimeError(f"layer-norm kernel needs CUDA tensors, got x "
                           f"on {x2d.device}")
    if x2d.dim() != 2 or not x2d.is_contiguous():
        raise RuntimeError("layer-norm kernel needs a contiguous 2-d x")
    if x2d.dtype not in _DTYPE_CODE:
        raise RuntimeError(f"layer-norm kernel takes fp32/bf16 x, got "
                           f"{x2d.dtype}")
    if mode not in ("ln", "rms"):
        raise ValueError(f"mode must be 'ln' or 'rms', got {mode!r}")
    rows, h = x2d.shape
    for name, t in (("weight", w), ("bias", b)):
        if t is None:
            continue
        if t.device != x2d.device or t.dtype not in _DTYPE_CODE \
                or t.shape != (h,) or not t.is_contiguous():
            raise RuntimeError(
                f"layer-norm kernel needs a contiguous fp32/bf16 ({h},) "
                f"{name} on {x2d.device}, got {tuple(t.shape)} "
                f"{t.dtype} on {t.device}")
    y = torch.empty_like(x2d)
    mean = torch.empty((rows, 1), device=x2d.device, dtype=torch.float32) \
        if mode == "ln" else None
    rstd = torch.empty((rows, 1), device=x2d.device, dtype=torch.float32)
    if rows == 0 or h == 0:
        return y, mean, rstd
    LN_FWD(x2d.data_ptr(), None if w is None else w.data_ptr(),
           None if b is None else b.data_ptr(), y.data_ptr(),
           None if mean is None else mean.data_ptr(), rstd.data_ptr(),
           rows, h, _DTYPE_CODE[x2d.dtype],
           _DTYPE_CODE[w.dtype] if w is not None else 0,
           _DTYPE_CODE[b.dtype] if b is not None else 0,
           int(mode == "rms"), float(eps),
           torch.cuda.current_stream(x2d.device).cuda_stream)
    return y, mean, rstd


def layer_norm_fwd(x2d, w, b, mode: str, eps: float):
    """Dispatch: kernel for a CUDA tensor, plain version for a CPU one."""
    if on_card(x2d, "x"):
        return layer_norm_fwd_kernel(x2d, w, b, mode, eps)
    return layer_norm_fwd_plain(x2d, w, b, mode, eps)


class _NormFwd(torch.autograd.Function):
    """Forward through :func:`layer_norm_fwd`; the backward kernel is a
    later slice, so differentiating raises."""

    @staticmethod
    def forward(ctx, x2d, w, b, mode, eps):
        y, _, _ = layer_norm_fwd(x2d, w, b, mode, eps)
        return y

    @staticmethod
    def backward(ctx, dy):
        raise NotImplementedError("backward kernel: later slice")


def _norm(x, weight, bias, normalized_shape, eps, mode):
    h = _normalized_size(normalized_shape)
    x2d = x.reshape(-1, h).contiguous()
    w = None if weight is None else weight.reshape(h).contiguous()
    b = None if bias is None else bias.reshape(h).contiguous()
    return _NormFwd.apply(x2d, w, b, mode, float(eps)).reshape(x.shape)


def fused_layer_norm_affine(x, weight, bias, normalized_shape: Shape,
                            eps: float = 1e-5):
    """LayerNorm over the trailing ``normalized_shape`` dims with affine
    params."""
    return _norm(x, weight, bias, normalized_shape, eps, "ln")


def fused_layer_norm(x, normalized_shape: Shape, eps: float = 1e-5):
    return _norm(x, None, None, normalized_shape, eps, "ln")


def fused_rms_norm_affine(x, weight, normalized_shape: Shape,
                          eps: float = 1e-5):
    return _norm(x, weight, None, normalized_shape, eps, "rms")


def fused_rms_norm(x, normalized_shape: Shape, eps: float = 1e-5):
    return _norm(x, None, None, normalized_shape, eps, "rms")


class FusedLayerNorm(nn.Module):
    """LayerNorm module (weight 1, bias 0; statistics fp32)."""

    mode = "ln"

    def __init__(self, normalized_shape: Shape, eps: float = 1e-5,
                 elementwise_affine: bool = True,
                 param_dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = (normalized_shape,)
        self.normalized_shape = tuple(normalized_shape)
        self.eps = float(eps)
        self.elementwise_affine = bool(elementwise_affine)
        self.weight = self.bias = None
        if self.elementwise_affine:
            self.weight = nn.Parameter(torch.ones(
                self.normalized_shape, dtype=param_dtype, device=device))
            if self.mode == "ln":
                self.bias = nn.Parameter(torch.zeros(
                    self.normalized_shape, dtype=param_dtype,
                    device=device))

    def forward(self, x):
        return _norm(x, self.weight, self.bias, self.normalized_shape,
                     self.eps, self.mode)


class FusedRMSNorm(FusedLayerNorm):
    """RMSNorm module: no mean subtraction, no bias."""

    mode = "rms"


class MixedFusedLayerNorm(FusedLayerNorm):
    """bf16 activations with fp32 params and fp32 statistics."""

    def __init__(self, normalized_shape: Shape, eps: float = 1e-5, **kw):
        kw.pop("param_dtype", None)
        super().__init__(normalized_shape, eps, param_dtype=torch.float32,
                         **kw)


class MixedFusedRMSNorm(FusedRMSNorm):
    def __init__(self, normalized_shape: Shape, eps: float = 1e-5, **kw):
        kw.pop("param_dtype", None)
        super().__init__(normalized_shape, eps, param_dtype=torch.float32,
                         **kw)

"""Fused LayerNorm / RMSNorm, forward and backward (counterpart of
``apex_tpu/normalization/fused_layer_norm.py``).

Contract, as in the JAX package: statistics and all arithmetic in fp32,
output in the input dtype; weight and bias may each be fp32 or bf16
(O2 casts every GPT leaf to bf16, norms included, but keeps BERT's
``layernorm`` leaves fp32). The forward also yields the fp32 mean (LN
only) and rstd that the backward consumes. The backward gives dx in
x's dtype and dgamma, dbeta in the weight's and bias's dtypes.

Dispatch: a CUDA tensor launches the hand-written kernels
(``csrc/layer_norm.cu``) or raises; a CPU tensor takes the plain
PyTorch versions below.
"""

import ctypes
import functools
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
LN_BWD = Kernel(LIB, "apx_layer_norm_bwd", [_P] * 10 + [_I] * 7 + [_P])
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_FWD_MAX_H = 32768    # 32 columns a thread of a 1024-thread team
_BWD_MAX_H = 8192     # 16 columns a thread of a 512-thread block


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


def _check_x(x2d: torch.Tensor) -> None:
    if x2d.device.type != "cuda":
        raise RuntimeError(f"layer-norm kernel needs CUDA tensors, got x "
                           f"on {x2d.device}")
    if x2d.dim() != 2 or not x2d.is_contiguous():
        raise RuntimeError("layer-norm kernel needs a contiguous 2-d x")
    if x2d.dtype not in _DTYPE_CODE:
        raise RuntimeError(f"layer-norm kernel takes fp32/bf16 x, got "
                           f"{x2d.dtype}")


def _check_params(x2d, w, b) -> None:
    h = x2d.shape[1]
    for name, t in (("weight", w), ("bias", b)):
        if t is None:
            continue
        if t.device != x2d.device or t.dtype not in _DTYPE_CODE \
                or t.shape != (h,) or not t.is_contiguous():
            raise RuntimeError(
                f"layer-norm kernel needs a contiguous fp32/bf16 ({h},) "
                f"{name} on {x2d.device}, got {tuple(t.shape)} "
                f"{t.dtype} on {t.device}")


def layer_norm_fwd_kernel(x2d: torch.Tensor, w: Optional[torch.Tensor],
                          b: Optional[torch.Tensor], mode: str, eps: float
                          ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                                     torch.Tensor]:
    """Launch ``csrc/layer_norm.cu`` on CUDA tensors; raises on anything
    the kernel does not take."""
    _check_x(x2d)
    if mode not in ("ln", "rms"):
        raise ValueError(f"mode must be 'ln' or 'rms', got {mode!r}")
    rows, h = x2d.shape
    _check_params(x2d, w, b)
    if h > _FWD_MAX_H:
        raise RuntimeError(f"layer-norm forward kernel takes h up to "
                           f"{_FWD_MAX_H}, got {h}")
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


def layer_norm_bwd_plain(dy2d: torch.Tensor, x2d: torch.Tensor,
                         w: Optional[torch.Tensor],
                         b: Optional[torch.Tensor],
                         mean: Optional[torch.Tensor], rstd: torch.Tensor
                         ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                                    Optional[torch.Tensor]]:
    """Plain PyTorch version of the backward kernel (the JAX
    ``_bwd_kernel``'s math, all in fp32): (dx in x's dtype, dgamma in
    w's dtype or None, dbeta in b's dtype or None). ``mean`` None means
    RMS; ``b`` only gives dbeta its dtype."""
    dy = dy2d.float()
    xhat = (x2d.float() - (0.0 if mean is None else mean)) * rstd
    wdy = dy * w.float() if w is not None else dy
    c1 = (xhat * wdy).mean(dim=1, keepdim=True)
    g = wdy - xhat * c1
    if mean is not None:
        g = g - wdy.mean(dim=1, keepdim=True)
    dx = (g * rstd).to(x2d.dtype)
    dw = None if w is None else (dy * xhat).sum(dim=0).to(w.dtype)
    db = None if b is None else dy.sum(dim=0).to(b.dtype)
    return dx, dw, db


_U = 2.0 ** -24   # fp32 unit roundoff


def bwd_limits(dy2d, x2d, w, mean, rstd, dx0, dw0, db0):
    """How far, per element, the backward kernel's (dx, dgamma, dbeta)
    may sit from the plain version's (``dx0``, ``dw0``, ``db0``) on the
    same inputs (None where there is no such output).

    Both compute in fp32 from the same saved mean and rstd and differ in
    the order of their sums: c1 and c2 over h, dgamma and dbeta over the
    rows. A sum of n terms taken in two orders differs by at most
    2 (n - 1) u sum|terms| (u = 2^-24); the products and differences
    around the sums add a few u of their operands. A bf16 output adds
    one ulp of the plain value (2^-7 |x0|), since each side rounds its
    fp32 value once."""
    rows, h = x2d.shape
    dy = dy2d.float()
    xhat = (x2d.float() - (0.0 if mean is None else mean)) * rstd
    wdy = dy * w.float() if w is not None else dy
    c1 = (xhat * wdy).abs().mean(dim=1, keepdim=True)
    c2 = wdy.abs().mean(dim=1, keepdim=True) if mean is not None else 0.0
    axc = xhat.abs() * c1 + c2
    lim_dx = rstd * (8 * _U * (wdy.abs() + axc) + 2 * h * _U * axc)

    def out(lim, x0):
        if x0 is None:
            return None
        if x0.dtype == torch.bfloat16:
            lim = lim + 2.0 ** -7 * x0.float().abs()
        return lim

    n = 2 * rows + 4
    return (out(lim_dx, dx0),
            out(n * _U * (dy * xhat).abs().sum(dim=0), dw0),
            out(n * _U * dy.abs().sum(dim=0), db0))


def bwd_grid(rows: int, n_sm: int) -> Tuple[int, int]:
    """The backward's stage-1 grid: (rows a block, blocks). One block an
    SM, each owning a contiguous run of rows (the last run may be
    shorter), so the fp32 partials the blocks write are (blocks, h)
    with blocks <= n_sm."""
    rows_per_block = -(-rows // n_sm)
    return rows_per_block, -(-rows // rows_per_block)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def layer_norm_bwd_kernel(dy2d: torch.Tensor, x2d: torch.Tensor,
                          w: Optional[torch.Tensor],
                          b: Optional[torch.Tensor],
                          mean: Optional[torch.Tensor], rstd: torch.Tensor
                          ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                                     Optional[torch.Tensor]]:
    """Launch the two-stage backward of ``csrc/layer_norm.cu`` on CUDA
    tensors: stage 1 (one block an SM, :func:`bwd_grid`) writes dx and
    one row of column partials a block into an fp32 scratch buffer,
    stage 2 sums them into dgamma and dbeta (no atomics: the same bits
    every run). Raises on anything the kernel does not take."""
    _check_x(x2d)
    rows, h = x2d.shape
    if dy2d.shape != x2d.shape or dy2d.dtype != x2d.dtype \
            or dy2d.device != x2d.device or not dy2d.is_contiguous():
        raise RuntimeError(f"layer-norm backward needs a contiguous dy "
                           f"like x {tuple(x2d.shape)} {x2d.dtype}, got "
                           f"{tuple(dy2d.shape)} {dy2d.dtype}")
    _check_params(x2d, w, b)
    for name, t in (("mean", mean), ("rstd", rstd)):
        if t is not None and (t.device != x2d.device
                              or t.dtype != torch.float32
                              or t.numel() != rows
                              or not t.is_contiguous()):
            raise RuntimeError(f"layer-norm backward needs the forward's "
                               f"fp32 ({rows}, 1) {name} on {x2d.device}")
    if h > _BWD_MAX_H:
        raise RuntimeError(f"layer-norm backward kernel takes h up to "
                           f"{_BWD_MAX_H}, got {h}")
    dx = torch.empty_like(x2d)
    dw = None if w is None else torch.empty_like(w)
    db = None if b is None else torch.empty_like(b)
    if rows == 0 or h == 0:
        for t in (dw, db):
            if t is not None:
                t.zero_()
        return dx, dw, db
    rows_per_block, n_blocks = bwd_grid(rows, _sm_count(x2d.device.index))

    def scratch(t):
        return None if t is None else torch.empty(
            (n_blocks, h), device=x2d.device, dtype=torch.float32)

    part_w, part_b = scratch(w), scratch(b)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    LN_BWD(dy2d.data_ptr(), x2d.data_ptr(), ptr(w), ptr(mean),
           rstd.data_ptr(), dx.data_ptr(), ptr(part_w), ptr(part_b),
           ptr(dw), ptr(db), rows, h, _DTYPE_CODE[x2d.dtype],
           _DTYPE_CODE[w.dtype] if w is not None else 0,
           _DTYPE_CODE[b.dtype] if b is not None else 0,
           int(mean is None), rows_per_block,
           torch.cuda.current_stream(x2d.device).cuda_stream)
    return dx, dw, db


class _Norm(torch.autograd.Function):
    """LN/RMS through :func:`layer_norm_fwd`; the backward launches the
    backward kernel (CUDA) or runs its plain version (CPU)."""

    @staticmethod
    def forward(ctx, x2d, w, b, mode, eps):
        y, mean, rstd = layer_norm_fwd(x2d, w, b, mode, eps)
        ctx.save_for_backward(x2d, w, b, mean, rstd)
        return y

    @staticmethod
    def backward(ctx, dy):
        x2d, w, b, mean, rstd = ctx.saved_tensors
        bwd = layer_norm_bwd_kernel if on_card(x2d, "x") \
            else layer_norm_bwd_plain
        dx, dw, db = bwd(dy.contiguous(), x2d, w, b, mean, rstd)
        return dx, dw, db, None, None


def _norm(x, weight, bias, normalized_shape, eps, mode):
    h = _normalized_size(normalized_shape)
    x2d = x.reshape(-1, h).contiguous()
    w = None if weight is None else weight.reshape(h).contiguous()
    b = None if bias is None else bias.reshape(h).contiguous()
    return _Norm.apply(x2d, w, b, mode, float(eps)).reshape(x.shape)


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

"""Fused softmax cross entropy (counterpart of
``apex_tpu/contrib/xentropy.py``): per-row loss without materialising
the log-softmax over the vocabulary.

Semantics, as in the JAX package:

- ``loss = lse - (1 - eps) * x[label] - eps * mean(x)`` (label smoothing
  spreads ``eps`` uniformly over the vocabulary);
- a row with ``label < 0`` is ignored: zero loss, zero gradient;
- the loss is always fp32; the backward recomputes the softmax from the
  saved natural-log lse: ``dx = (softmax(x) - smoothed one-hot) *
  dloss``, in the logits' dtype.

Dispatch: a CUDA tensor launches the hand-written kernels
(``csrc/xentropy.cu``) or raises; a CPU tensor takes the plain PyTorch
versions below.
"""

import ctypes
import math
from typing import Optional, Tuple

import torch

from apex_tpu_torch.utils.cuda_build import CudaLibrary, Kernel
from apex_tpu_torch.utils.platform import on_card

LIB = CudaLibrary("xentropy")
_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
XENT_FWD = Kernel(LIB, "apx_xentropy_fwd", [_P] * 4 + [_I] * 3 + [_F, _F, _P])
XENT_BWD = Kernel(LIB, "apx_xentropy_bwd",
                  [_P] * 5 + [_I] * 3 + [_F, _F, _I, _P])
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _target(x: torch.Tensor, labels: torch.Tensor, eps: float
            ) -> torch.Tensor:
    """(1 - eps) * one-hot(label) + eps / v, fp32 (no one-hot for a label
    outside [0, v))."""
    v = x.shape[1]
    cols = torch.arange(v, device=x.device)
    onehot = (cols[None, :] == labels[:, None]).float()
    target = (1.0 - eps) * onehot
    if eps > 0.0:
        target = target + eps / v
    return target


def xentropy_fwd_plain(logits: torch.Tensor, labels: torch.Tensor,
                       eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the forward kernel: (loss, lse), both (n,)
    fp32."""
    x = logits.float()
    lse = torch.logsumexp(x, dim=1)
    v = x.shape[1]
    zero = torch.zeros((), device=x.device)
    xy = x.gather(1, labels.clamp(0, v - 1)[:, None])[:, 0]
    xy = torch.where((labels >= 0) & (labels < v), xy, zero)
    loss = lse - (1.0 - eps) * xy
    if eps > 0.0:
        loss = loss - eps * x.sum(1) / v
    return torch.where(labels < 0, zero, loss), lse


def xentropy_bwd_plain(logits: torch.Tensor, labels: torch.Tensor,
                       lse: torch.Tensor, dloss: torch.Tensor,
                       eps: float) -> torch.Tensor:
    """Plain version of the backward kernel: dx in the logits' dtype."""
    x = logits.float()
    g = (torch.exp(x - lse[:, None]) - _target(x, labels, eps)) \
        * dloss.float()[:, None]
    g = torch.where((labels >= 0)[:, None], g, torch.zeros((), device=x.device))
    return g.to(logits.dtype)


_U = 2.0 ** -24   # fp32 unit roundoff


def limits(logits, labels, eps: float, loss0, lse0, dloss, dx0):
    """How far, per element, the kernels' (loss, lse, dx) may sit from
    the plain versions' (``loss0``, ``lse0``, ``dx0``) on the same
    inputs.

    The row sum l = sum exp(x - m) is taken in two orders: the kernel
    adds about v / 256 terms in each thread and merges 256 partial sums
    in a tree, torch in its own blocked order. Both stay within (v / 256
    + 2 log2 v + 16) u of the exact sum relative to it (u = 2^-24; exp
    adds two ulps a term), so lse moves by twice that, absolute. The
    loss adds one rounding of each term and, with smoothing, the same
    sum-order bound on sum x times eps / v. dx = (exp(x - lse) - target)
    dloss moves by softmax(x) times (the lse shift + 4 u) plus 4 u of
    |dx0|; a bf16 dx adds one ulp of dx0 (2^-7 |dx0|)."""
    x = logits.float()
    v = x.shape[1]
    e_lse = 2 * (v / 256 + 2 * math.log2(max(v, 2)) + 16) * _U
    e_lse = torch.full_like(lse0, e_lse)
    xy = x.gather(1, labels.clamp(0, v - 1)[:, None])[:, 0].abs()
    lim_loss = e_lse + 4 * _U * (loss0.abs() + lse0.abs() + xy)
    if eps > 0.0:
        lim_loss = lim_loss + eps * 2 * (v / 256 + 2 * math.log2(v)) \
            * _U * x.abs().mean(1)
    soft = torch.exp(x - lse0[:, None])
    dxa = dx0.float().abs()
    lim_dx = soft * (e_lse[:, None] + 4 * _U) * dloss.float().abs()[:, None] \
        + (2.0 ** -7 if dx0.dtype == torch.bfloat16 else 4 * _U) * dxa
    return lim_loss, e_lse, lim_dx


def _check(logits: torch.Tensor, labels: torch.Tensor) -> None:
    if logits.device.type != "cuda":
        raise RuntimeError(f"xentropy kernel needs CUDA tensors, got logits "
                           f"on {logits.device}")
    if logits.dim() != 2 or not logits.is_contiguous() \
            or logits.dtype not in _DTYPE_CODE:
        raise RuntimeError(f"xentropy kernel needs contiguous 2-d fp32/bf16 "
                           f"logits, got {tuple(logits.shape)} {logits.dtype}")
    n = logits.shape[0]
    if labels.shape != (n,) or labels.dtype != torch.int64 \
            or labels.device != logits.device or not labels.is_contiguous():
        raise RuntimeError(f"xentropy kernel needs contiguous int64 ({n},) "
                           f"labels on {logits.device}, got "
                           f"{tuple(labels.shape)} {labels.dtype} on "
                           f"{labels.device}")


def _check_row(t: torch.Tensor, n: int, dev, name: str) -> None:
    if t.shape != (n,) or t.dtype != torch.float32 or t.device != dev \
            or not t.is_contiguous():
        raise RuntimeError(f"xentropy kernel needs a contiguous fp32 ({n},) "
                           f"{name} on {dev}")


def xentropy_fwd_kernel(logits: torch.Tensor, labels: torch.Tensor,
                        eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the forward kernel of ``csrc/xentropy.cu``: (loss, lse),
    both (n,) fp32. Raises on anything the kernel does not take."""
    _check(logits, labels)
    n, v = logits.shape
    loss = torch.empty((n,), device=logits.device, dtype=torch.float32)
    lse = torch.empty_like(loss)
    if n == 0:
        return loss, lse
    if v == 0:
        raise RuntimeError("xentropy kernel needs a non-empty vocabulary")
    XENT_FWD(logits.data_ptr(), labels.data_ptr(), loss.data_ptr(),
             lse.data_ptr(), n, v, _DTYPE_CODE[logits.dtype],
             float(1.0 - eps), float(eps),
             torch.cuda.current_stream(logits.device).cuda_stream)
    return loss, lse


def xentropy_bwd_kernel(logits: torch.Tensor, labels: torch.Tensor,
                        lse: torch.Tensor, dloss: torch.Tensor,
                        eps: float) -> torch.Tensor:
    """Launch the backward kernel of ``csrc/xentropy.cu``: dx in the
    logits' dtype. Raises on anything the kernel does not take."""
    _check(logits, labels)
    n, v = logits.shape
    _check_row(lse, n, logits.device, "lse")
    _check_row(dloss, n, logits.device, "dloss")
    dx = torch.empty_like(logits)
    if n == 0 or v == 0:
        return dx
    XENT_BWD(logits.data_ptr(), labels.data_ptr(), lse.data_ptr(),
             dloss.data_ptr(), dx.data_ptr(), n, v,
             _DTYPE_CODE[logits.dtype], float(1.0 - eps), float(eps / v),
             int(eps > 0.0),
             torch.cuda.current_stream(logits.device).cuda_stream)
    return dx


class _Xent(torch.autograd.Function):
    """Forward and backward kernels (CUDA) or plain versions (CPU)."""

    @staticmethod
    def forward(ctx, logits, labels, eps):
        card = on_card(logits, "logits")
        fwd = xentropy_fwd_kernel if card else xentropy_fwd_plain
        loss, lse = fwd(logits, labels, eps)
        ctx.save_for_backward(logits, labels, lse)
        ctx.eps = eps
        return loss

    @staticmethod
    def backward(ctx, dloss):
        logits, labels, lse = ctx.saved_tensors
        bwd = xentropy_bwd_kernel if on_card(logits, "logits") \
            else xentropy_bwd_plain
        return bwd(logits, labels, lse, dloss.float().contiguous(),
                   ctx.eps), None, None


def softmax_cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                               smoothing: float = 0.0) -> torch.Tensor:
    """Per-row cross entropy without materialising the log-softmax.

    logits: (N, V); labels: (N,) int, negative = ignore. Returns (N,)
    fp32 losses."""
    return _Xent.apply(logits.contiguous(),
                       labels.to(torch.int64).contiguous(), float(smoothing))


class SoftmaxCrossEntropyLoss:
    """API-parity shim for the reference module (``half_to_float`` is
    implicit: losses are always fp32)."""

    @staticmethod
    def apply(logits, labels, smoothing: float = 0.0,
              padding_idx: Optional[int] = None, half_to_float: bool = True):
        if padding_idx is not None:
            labels = torch.where(labels == padding_idx,
                                 torch.full_like(labels, -1), labels)
        return softmax_cross_entropy_loss(logits, labels, smoothing)

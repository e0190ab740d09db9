"""Fused scale + mask + softmax and its dispatcher (counterpart of
``apex_tpu/transformer/functional/fused_softmax.py``): the Megatron
fused softmax of BERT's unfused attention.

Semantics, as in the JAX package:

- ``z = x * scale`` in fp32, then masked positions are set to -10000
  (``_MASK_VALUE``; not scaled, not -inf), ``y = softmax(z)`` over the
  last axis, stored in ``x.dtype``. A row masked everywhere is therefore
  uniform, ``1 / sk``.
- The padding mask is "nonzero = masked out", broadcastable to ``(b, 1,
  sq, sk)`` (BERT passes ``(b, 1, 1, sk)``); it is read through strides,
  never expanded in memory. The causal softmax masks key ``k > q``.
- The backward is ``dx = scale * (dy - sum(y * dy)) * y`` in fp32,
  stored in ``y.dtype``, from the saved ``y`` (the JAX ``custom_vjp``
  residual); the mask and the scale get no gradient.

Dispatch: a CUDA tensor launches the hand-written kernels
(``csrc/fused_softmax.cu``) or raises; a CPU tensor takes the plain
PyTorch versions below. ``FusedScaleMaskSoftmax.forward_torch_softmax``
is the JAX package's own documented branch for fp32 inputs,
``scaled_masked_softmax_fusion=False`` and ``sq == 1``
(``is_kernel_available``), taken by rule on every device; it is not a
fallback around a kernel that failed.
"""

import ctypes
from typing import Callable, Optional

import torch

from apex_tpu_torch.transformer.enums import AttnMaskType
from apex_tpu_torch.utils.cuda_build import CudaLibrary, Kernel
from apex_tpu_torch.utils.platform import on_card

_MASK_VALUE = -10000.0  # the reference kernels' masked-score constant

LIB = CudaLibrary("fused_softmax")
_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
SOFTMAX_FWD = Kernel(LIB, "apx_softmax_masked_fwd",
                     [_P] * 3 + [_I] * 4 + [_L] * 4 + [_I, _I, _F, _P])
SOFTMAX_CAUSAL_FWD = Kernel(LIB, "apx_softmax_causal_fwd",
                            [_P, _P] + [_I] * 4 + [_F, _P])
SOFTMAX_BWD = Kernel(LIB, "apx_softmax_bwd", [_P] * 3 + [_L, _I, _I, _F, _P])
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _softmax_rows(z: torch.Tensor) -> torch.Tensor:
    e = torch.exp(z - z.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


def masked_softmax_fwd_plain(x: torch.Tensor, mask: torch.Tensor,
                             scale: float) -> torch.Tensor:
    """Plain version of the padding-mask kernel; x (b, np, sq, sk)."""
    z = x.float() * scale
    z = torch.where(mask != 0, _MASK_VALUE, z)
    return _softmax_rows(z).to(x.dtype)


def _causal(sq: int, sk: int, device) -> torch.Tensor:
    """(sq, sk) bool, True where key k > query q (masked out)."""
    return torch.arange(sk, device=device)[None, :] > \
        torch.arange(sq, device=device)[:, None]


def causal_softmax_fwd_plain(x3: torch.Tensor, scale: float) -> torch.Tensor:
    """Plain version of the causal kernel; x3 (batches, sq, sk)."""
    z = x3.float() * scale
    z = torch.where(_causal(*x3.shape[1:], x3.device), _MASK_VALUE, z)
    return _softmax_rows(z).to(x3.dtype)


def softmax_bwd_plain(y: torch.Tensor, dy: torch.Tensor,
                      scale: float) -> torch.Tensor:
    """Plain version of the backward kernel: dx in y's dtype."""
    yf, g = y.float(), dy.float()
    s = (yf * g).sum(dim=-1, keepdim=True)
    return (scale * (g - s) * yf).to(y.dtype)


# ---------------------------------------------------------------------------
# error models
# ---------------------------------------------------------------------------

_U = 2.0 ** -24                                     # fp32 unit roundoff
_ULP = {torch.bfloat16: 2.0 ** -7, torch.float16: 2.0 ** -10}
_SUBNORMAL = {torch.float32: 2.0 ** -126, torch.bfloat16: 2.0 ** -126,
              torch.float16: 2.0 ** -24}


def _stored(lim: torch.Tensor, mag: torch.Tensor,
            dtype: torch.dtype) -> torch.Tensor:
    """An fp32 limit carried through one rounding of both sides to
    ``dtype``: at most one ulp of the value (2^-7 relative for bf16,
    2^-10 for fp16) more, plus the dtype's subnormal step."""
    if dtype in _ULP:
        r = _ULP[dtype]
        lim = lim * (1 + r) + r * (1 + r) * mag
    return lim + _SUBNORMAL[dtype]


def fwd_limits(y0: torch.Tensor) -> torch.Tensor:
    """How far, per element, a forward's y may sit from ``y0``, another
    forward's y on the same inputs. Both compute the same z and max; the
    row sum of the sk positive terms exp(z - max) is taken in other
    orders, each within (sk - 1) u of the exact sum relative to it (u =
    2^-24), exp adds two ulps a term, the division one rounding: y moves
    by (2 (sk - 1) + 12) u of itself. A bf16 or fp16 y adds one ulp.

    The card's forwards divide by the row sum as one correctly rounded
    reciprocal of it and a multiply a score: two roundings where a
    division takes one. Per side, exp's two ulps on the term and on the
    sum and the division's rounding come to 5 u; with the reciprocal 6 u,
    so two sides differ by at most 11 u besides the sum orders' 2 (sk -
    1) u, within the 12 u the limit grants (the second-order terms are
    of order (sk u)^2). ``tests/test_torch_fused_softmax.py`` emulates
    that form on the CPU against the plain version and the JAX package
    within this limit."""
    mag = y0.float().abs()
    lim = (2 * (y0.shape[-1] - 1) + 12) * _U * mag
    return _stored(lim, mag, y0.dtype)


def bwd_limits(y: torch.Tensor, dy: torch.Tensor, scale: float,
               dx0: torch.Tensor,
               y_err: Optional[torch.Tensor] = None) -> torch.Tensor:
    """How far, per element, a backward's dx may sit from ``dx0``, the
    plain version's on (``y``, ``dy``). s = sum y dy in two orders
    differs by 2 (sk + 1) u sum |y dy|; with ``y_err`` (a per-element
    bound on the difference between the y the two sides were given) s
    moves by sum |dy| y_err more and dx by |scale| |dy - s| y_err. Three
    fp32 roundings a side add 8 u of |dx0|; a bf16 or fp16 dx one ulp."""
    yf, g = y.float(), dy.float()
    sk = yf.shape[-1]
    s = (yf * g).sum(dim=-1, keepdim=True)
    ds = 2 * (sk + 1) * _U * (yf * g).abs().sum(dim=-1, keepdim=True)
    ya = yf.abs()
    lim = torch.zeros_like(yf)
    if y_err is not None:
        ds = ds + (g.abs() * y_err).sum(dim=-1, keepdim=True)
        lim = (g - s).abs() * y_err
        ya = ya + y_err
    mag = dx0.float().abs()
    lim = abs(scale) * (lim + ya * ds) + 8 * _U * mag
    return _stored(lim, mag, dx0.dtype)


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------

def _check_x(x: torch.Tensor, ndim: int, name: str = "x") -> None:
    if x.device.type != "cuda":
        raise RuntimeError(f"fused softmax kernel needs CUDA tensors, got "
                           f"{name} on {x.device}")
    if x.dim() != ndim or not x.is_contiguous() or x.dtype not in _DTYPE_CODE:
        raise RuntimeError(
            f"fused softmax kernel needs a contiguous {ndim}-d fp32/bf16/"
            f"fp16 {name}, got {tuple(x.shape)} {x.dtype}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def masked_softmax_fwd_kernel(x: torch.Tensor, mask: torch.Tensor,
                              scale: float) -> torch.Tensor:
    """Launch the padding-mask kernel of ``csrc/fused_softmax.cu``; x
    (b, np, sq, sk), mask broadcastable to (b, 1, sq, sk), read in place
    through strides (int32 or bool/uint8; any other integer dtype is
    first compared with 0)."""
    _check_x(x, 4)
    b, np_, sq, sk = x.shape
    if mask.device != x.device:
        raise RuntimeError(f"fused softmax kernel needs the mask on "
                           f"{x.device}, got {mask.device}")
    if mask.dtype not in (torch.int32, torch.bool, torch.uint8):
        mask = mask != 0
    m4 = mask.expand(b, 1, sq, sk).expand(b, np_, sq, sk)
    y = torch.empty_like(x)
    if y.numel() == 0:
        return y
    SOFTMAX_FWD(x.data_ptr(), m4.data_ptr(), y.data_ptr(), b, np_, sq, sk,
                *m4.stride(), int(m4.dtype != torch.int32),
                _DTYPE_CODE[x.dtype], float(scale), _stream(x))
    return y


def causal_softmax_fwd_kernel(x3: torch.Tensor, scale: float
                              ) -> torch.Tensor:
    """Launch the causal kernel of ``csrc/fused_softmax.cu``; x3
    (batches, sq, sk)."""
    _check_x(x3, 3)
    y = torch.empty_like(x3)
    if y.numel() == 0:
        return y
    SOFTMAX_CAUSAL_FWD(x3.data_ptr(), y.data_ptr(), *x3.shape,
                       _DTYPE_CODE[x3.dtype], float(scale), _stream(x3))
    return y


def softmax_bwd_kernel(y: torch.Tensor, dy: torch.Tensor,
                       scale: float) -> torch.Tensor:
    """Launch the backward kernel of ``csrc/fused_softmax.cu``: dx in
    y's dtype, for y and dy of one shape (any rank, rows of sk)."""
    _check_x(y, y.dim(), "y")
    _check_x(dy, y.dim(), "dy")
    if dy.shape != y.shape or dy.dtype != y.dtype or dy.device != y.device:
        raise RuntimeError(f"fused softmax backward needs dy like y "
                           f"{tuple(y.shape)} {y.dtype}, got "
                           f"{tuple(dy.shape)} {dy.dtype}")
    dx = torch.empty_like(y)
    if dx.numel() == 0:
        return dx
    sk = y.shape[-1]
    SOFTMAX_BWD(y.data_ptr(), dy.data_ptr(), dx.data_ptr(), y.numel() // sk,
                sk, _DTYPE_CODE[y.dtype], float(scale), _stream(y))
    return dx


def _bwd(y, dy, scale):
    bwd = softmax_bwd_kernel if on_card(y, "y") else softmax_bwd_plain
    return bwd(y, dy.contiguous(), scale)


class _MaskedSoftmax(torch.autograd.Function):
    """Padding-mask forward and backward kernels (CUDA) or plain
    versions (CPU); saves y."""

    @staticmethod
    def forward(ctx, x, mask, scale):
        fwd = masked_softmax_fwd_kernel if on_card(x) \
            else masked_softmax_fwd_plain
        y = fwd(x, mask, scale)
        ctx.save_for_backward(y)
        ctx.scale = scale
        return y

    @staticmethod
    def backward(ctx, dy):
        y, = ctx.saved_tensors
        return _bwd(y, dy, ctx.scale), None, None


class _CausalSoftmax(torch.autograd.Function):
    """Causal forward and backward kernels (CUDA) or plain versions
    (CPU); saves y."""

    @staticmethod
    def forward(ctx, x3, scale):
        fwd = causal_softmax_fwd_kernel if on_card(x3) \
            else causal_softmax_fwd_plain
        y = fwd(x3, scale)
        ctx.save_for_backward(y)
        ctx.scale = scale
        return y

    @staticmethod
    def backward(ctx, dy):
        y, = ctx.saved_tensors
        return _bwd(y, dy, ctx.scale), None


def scaled_masked_softmax(x: torch.Tensor, mask: torch.Tensor,
                          scale: float = 1.0) -> torch.Tensor:
    """x: (b, np, sq, sk); mask: (b, 1, sq, sk) or broadcastable,
    nonzero = masked out. Returns probabilities in x.dtype."""
    return _MaskedSoftmax.apply(x.contiguous(), mask, float(scale))


def scaled_upper_triang_masked_softmax(x: torch.Tensor,
                                       scale: float = 1.0) -> torch.Tensor:
    """Causal softmax. x: (attn_batches, sq, sk), or (b, np, sq, sk),
    which is flattened."""
    if x.dim() == 4:
        b, np_, sq, sk = x.shape
        return _CausalSoftmax.apply(
            x.reshape(b * np_, sq, sk).contiguous(), float(scale)
        ).reshape(x.shape)
    return _CausalSoftmax.apply(x.contiguous(), float(scale))


class FusedScaleMaskSoftmax:
    """The reference's dispatcher: the fused kernels when
    :meth:`is_kernel_available`, else :meth:`forward_torch_softmax`."""

    def __init__(self, input_in_fp16: bool = False,
                 input_in_bf16: bool = False,
                 attn_mask_type: AttnMaskType = AttnMaskType.padding,
                 scaled_masked_softmax_fusion: bool = True,
                 mask_func: Optional[Callable] = None,
                 softmax_in_fp32: bool = True,
                 scale: Optional[float] = None):
        if input_in_fp16 and input_in_bf16:
            raise RuntimeError("both fp16 and bf16 flags are set")
        self.input_in_float16 = input_in_fp16 or input_in_bf16
        self.attn_mask_type = attn_mask_type
        self.fusion = scaled_masked_softmax_fusion
        self.mask_func = mask_func
        self.softmax_in_fp32 = softmax_in_fp32
        self.scale = scale
        if scale is not None and not softmax_in_fp32:
            raise RuntimeError("softmax should be in fp32 when scaled")

    def is_kernel_available(self, mask, b, np_, sq, sk) -> bool:
        """The JAX package's gate: the fusion flag, half-precision input
        (fp32 callers take :meth:`forward_torch_softmax`, the same
        numerics) and ``sq > 1`` (a one-query softmax is not worth a
        dispatch). The reference CUDA kernels' seqlen limits do not
        apply: these kernels take any sk."""
        return bool(self.fusion) and self.input_in_float16 and sq > 1

    def __call__(self, x: torch.Tensor,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        scale = self.scale if self.scale is not None else 1.0
        b, np_, sq, sk = x.shape
        if self.is_kernel_available(mask, b, np_, sq, sk):
            if self.attn_mask_type == AttnMaskType.causal:
                return scaled_upper_triang_masked_softmax(x, scale)
            if mask is not None:
                return scaled_masked_softmax(x, mask, scale)
            # no mask: the scale-only softmax is the masked kernel with a
            # zero mask
            zero = torch.zeros((b, 1, 1, sk), dtype=torch.int32,
                               device=x.device)
            return scaled_masked_softmax(x, zero, scale)
        return self.forward_torch_softmax(x, mask)

    forward_fused_softmax = __call__

    def forward_torch_softmax(self, x: torch.Tensor,
                              mask: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
        """The reference's ``forward_torch_softmax``, in plain PyTorch."""
        z = x.float() if self.softmax_in_fp32 else x
        if self.scale is not None:
            z = z * self.scale
        if self.attn_mask_type == AttnMaskType.causal:
            z = torch.where(_causal(*z.shape[-2:], z.device), _MASK_VALUE, z)
        elif mask is not None:
            if self.mask_func is not None:
                z = self.mask_func(z, mask)
            else:
                z = torch.where(mask != 0, _MASK_VALUE, z)
        y = torch.softmax(z, dim=-1)
        return y.to(x.dtype) if self.softmax_in_fp32 else y

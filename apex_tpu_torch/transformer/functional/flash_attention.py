"""Fused attention forward (counterpart of
``apex_tpu/transformer/functional/flash_attention.py``), JAX layout
``(batch, heads, seq, head_dim)``.

Two versions of one function:

- the kernel (``csrc/flash_attention.cu``): tiled attention with a
  base-2 online softmax — ``softmax_scale * log2(e)`` is folded into a
  one-rounding prescale of q — p rounded to the value dtype before the
  PV product, statistics and the accumulator in fp32; it also returns
  the base-2 logsumexp the backward kernels will need;
- the plain version, the port of the JAX ``_unfused_attention``: scores
  in fp32 (q and k upcast), softmax normalised, then dropout.

Both mask scores with the optional ``(batch, s_k)`` key mask (1 =
attend) and the causal mask, give 0 for fully masked rows, and drop
probabilities AFTER normalisation with the same position hash
(:func:`hash_keep`, bit for bit the JAX ``_hash_keep``), so their keep
masks are equal.

Dispatch: on a CUDA tensor :func:`flash_attention` always launches the
kernel or raises (the JAX package's seq-256 crossover was a TPU v5e
tuning, and the port keeps no ``use_kernel`` switch); on a CPU tensor
it runs the plain version. The backward kernels are a later slice:
differentiating raises.
"""

import ctypes
import math
from typing import Optional, Sequence, Tuple

import torch

from apex_tpu_torch.utils.cuda_build import CudaLibrary, Kernel
from apex_tpu_torch.utils.platform import on_card

LOG2E = 1.4426950408889634
_NEG = -1e30
_M32 = 0xFFFFFFFF
_MAX_D = 128

LIB = CudaLibrary("flash_attention")
_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_U = ctypes.c_uint
FLASH_FWD = Kernel(LIB, "apx_flash_attention_fwd",
                   [_P] * 6 + [_I] * 5 + [_L] * 12
                   + [_I, _I, ctypes.c_float, _I, ctypes.c_float, _U, _U, _U,
                      _P])
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 ``x`` in [0, 2^32): split ``c`` in
    16-bit halves so no int64 product overflows."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def hash_keep(qpos: torch.Tensor, kpos: torch.Tensor, head: torch.Tensor,
              seed_lo: int, seed_hi: int, rate: float) -> torch.Tensor:
    """The JAX ``_hash_keep`` on int64 tensors holding uint32 values
    (torch's uint32 arithmetic is thin): a splitmix32-style mix of the
    global (head, q, k) position and the two seed words, masked to 32
    bits after every step. Returns the keep mask (~(1 - rate) kept)."""
    x = _mul32(qpos, 0x9E3779B9) ^ _mul32(kpos, 0x85EBCA6B)
    x = x ^ ((int(seed_lo) + _mul32(head, 0xC2B2AE35)) & _M32)
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ ((int(seed_hi) + (x >> 15)) & _M32)
    x = _mul32(x, 0x846CA68B)
    x = x ^ (x >> 16)
    return x >= _threshold(rate)


def _threshold(rate: float) -> int:
    return min(int(rate * 2.0 ** 32), 2 ** 32 - 1)


def attention_probs(q, k, mask, *, causal: bool, scale: float
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Softmax probabilities (b, h, s_q, s_k) fp32 from fp32 scores (q
    and k upcast), 0 where masked and on fully masked rows, and the
    base-2 logsumexp (b*h, s_q), +inf on fully masked rows."""
    b, h, sq, _ = q.shape
    sk = k.shape[2]
    dev = q.device
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if mask is None:
        valid = torch.ones((1, 1, 1, sk), dtype=torch.bool, device=dev)
    else:
        valid = (mask != 0)[:, None, None, :]
    if causal:
        tri = torch.arange(sk, device=dev)[None, :] \
            <= torch.arange(sq, device=dev)[:, None]
        valid = valid & tri[None, None]
    s = torch.where(valid, s, torch.full((), _NEG, device=dev))
    m = s.amax(-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - m), torch.zeros((), device=dev))
    l = p.sum(-1, keepdim=True)
    p = torch.where(l > 0, p / torch.where(l > 0, l, torch.ones_like(l)),
                    torch.zeros((), device=dev))
    lse = torch.where(l[..., 0] > 0, (m[..., 0] + torch.log(l[..., 0]))
                      * LOG2E, torch.full((), math.inf, device=dev))
    return p, lse.reshape(b * h, sq)


def attention_fwd_plain(q, k, v, mask, seed: Sequence[int], *,
                        causal: bool, scale: float, rate: float
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Port of the JAX ``_unfused_attention``; also returns the base-2
    logsumexp (b*h, s_q) the kernel emits (+inf on fully masked rows)."""
    b, h, sq, _ = q.shape
    sk = k.shape[2]
    dev = q.device
    p, lse = attention_probs(q, k, mask, causal=causal, scale=scale)
    if rate > 0.0:
        bh = torch.arange(b * h, device=dev).reshape(b, h, 1, 1)
        qpos = torch.arange(sq, device=dev).reshape(1, 1, sq, 1)
        kpos = torch.arange(sk, device=dev).reshape(1, 1, 1, sk)
        keep = hash_keep(qpos, kpos, bh, seed[0], seed[1], rate)
        p = torch.where(keep, p / (1.0 - rate), torch.zeros((), device=dev))
    o = torch.matmul(p.to(v.dtype).float(), v.float()).to(q.dtype)
    return o, lse


def o_limit(q, k, v, mask, o0, *, causal: bool, scale: float
            ) -> torch.Tensor:
    """How far, per element, the kernel's o may sit from the plain
    version's ``o0`` on the same inputs. fp32: 1e-5 (|o0| + 1). bf16:
    one ulp of o0 (2^-7 |o0|; each side rounds an fp32 value once) plus
    2^-5 sqrt(sum_j p_j^2 v_j^2), the scale of the random error that
    rounding p (2^-9 relative, on both sides) and the prescaled q (about
    2^-9 in each score) put into o, some 16 times its standard
    deviation."""
    a = o0.float().abs()
    if q.dtype == torch.float32:
        return 1e-5 * (a + 1.0)
    p, _ = attention_probs(q, k, mask, causal=causal, scale=scale)
    return 2.0 ** -7 * a + 2.0 ** -5 * torch.sqrt(
        torch.matmul(p * p, v.float() ** 2))


def attention_fwd_kernel(q, k, v, mask, seed: Sequence[int], *,
                         causal: bool, scale: float, rate: float
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/flash_attention.cu``. q, k, v: CUDA (b, h, s, d),
    fp32 or bf16 alike, any strides with unit stride over d. Returns o
    (b, h, s_q, d) — laid out (b, s_q, h, d) in memory so that merging
    the heads back is free — and the base-2 lse (b*h, s_q) fp32."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda":
            raise RuntimeError(f"flash kernel needs CUDA tensors, got "
                               f"{name} on {t.device}")
        if t.dim() != 4 or t.stride(-1) != 1:
            raise RuntimeError(f"flash kernel needs 4-d {name} with unit "
                               "stride over head_dim")
        if t.dtype != q.dtype or t.dtype not in _DTYPE_CODE:
            raise RuntimeError(f"flash kernel takes fp32/bf16 q, k, v of "
                               f"one dtype, got {name} {t.dtype}")
        if t.device != q.device:
            raise RuntimeError("q, k, v must share one device")
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if k.shape != (b, h, sk, d) or v.shape != (b, h, sk, d):
        raise RuntimeError(f"k, v shapes {tuple(k.shape)}, "
                           f"{tuple(v.shape)} do not match q {tuple(q.shape)}")
    if not 0 < d <= _MAX_D:
        raise RuntimeError(f"flash kernel takes head_dim up to {_MAX_D}, "
                           f"got {d}")
    if sk < 1 or (sq + 31) // 32 > 65535:
        raise RuntimeError(f"flash kernel: unsupported s_q={sq}, s_k={sk}")
    if mask is not None:
        if mask.shape != (b, sk) or mask.device != q.device:
            raise RuntimeError(f"mask must be ({b}, {sk}) on {q.device}, "
                               f"got {tuple(mask.shape)} on {mask.device}")
        mask = mask.to(torch.int32).contiguous()
    o = torch.empty((b, sq, h, d), device=q.device,
                    dtype=q.dtype).transpose(1, 2)
    lse = torch.empty((b * h, sq), device=q.device, dtype=torch.float32)
    if sq == 0 or b * h == 0:
        return o, lse
    drop_scale = 1.0
    if rate > 0.0:
        drop_scale = torch.tensor(1.0 / (1.0 - rate)).to(q.dtype).item()
    FLASH_FWD(q.data_ptr(), k.data_ptr(), v.data_ptr(),
              None if mask is None else mask.data_ptr(), o.data_ptr(),
              lse.data_ptr(), b, h, sq, sk, d,
              q.stride(0), q.stride(1), q.stride(2),
              k.stride(0), k.stride(1), k.stride(2),
              v.stride(0), v.stride(1), v.stride(2),
              o.stride(0), o.stride(1), o.stride(2),
              _DTYPE_CODE[q.dtype], int(causal), float(scale * LOG2E),
              int(rate > 0.0), float(drop_scale), _threshold(rate),
              int(seed[0]) & _M32, int(seed[1]) & _M32,
              torch.cuda.current_stream(q.device).cuda_stream)
    return o, lse


class _FlashFwd(torch.autograd.Function):
    """Forward only; the dq and dk/dv kernels are a later slice."""

    @staticmethod
    def forward(ctx, q, k, v, mask, seed, causal, scale, rate):
        fwd = attention_fwd_kernel if on_card(q, "q") else attention_fwd_plain
        o, _ = fwd(q, k, v, mask, seed, causal=causal, scale=scale,
                   rate=rate)
        return o

    @staticmethod
    def backward(ctx, do):
        raise NotImplementedError("backward kernel: later slice")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask: Optional[torch.Tensor] = None, *,
                    causal: bool = False,
                    softmax_scale: Optional[float] = None,
                    dropout_rate: float = 0.0,
                    dropout_seed: Optional[Sequence[int]] = None
                    ) -> torch.Tensor:
    """Scaled-dot-product attention.

    Args:
      q, k, v: (batch, heads, seq, head_dim).
      mask: optional (batch, s_k) with 1 = attend.
      causal: apply the implicit upper-triangular mask.
      softmax_scale: defaults to 1/sqrt(head_dim).
      dropout_rate: probability dropout after normalisation; active
        only when ``dropout_seed`` is given.
      dropout_seed: two uint32 words seeding the position hash (the JAX
        function draws them as ``jax.random.bits(rng, (2,), uint32)``).

    Returns (batch, heads, seq, head_dim) in q's dtype.
    """
    if softmax_scale is None:
        softmax_scale = 1.0 / (q.shape[-1] ** 0.5)
    rate = float(dropout_rate) if dropout_seed is not None else 0.0
    seed = (0, 0) if rate <= 0.0 else \
        (int(dropout_seed[0]) & _M32, int(dropout_seed[1]) & _M32)
    return _FlashFwd.apply(q, k, v, mask, seed, bool(causal),
                           float(softmax_scale), rate)

"""Fused attention, forward and backward (counterpart of
``apex_tpu/transformer/functional/flash_attention.py``), JAX layout
``(batch, heads, seq, head_dim)``.

Forward, two versions of one function:

- the kernel (``csrc/flash_attention.cu``): tiled attention with a
  base-2 online softmax — ``softmax_scale * log2(e)`` is folded into a
  one-rounding prescale of q — p rounded to the value dtype before the
  PV product, statistics and the accumulator in fp32; it also returns
  the base-2 logsumexp the backward kernels consume;
- the plain version, the port of the JAX ``_unfused_attention``: scores
  in fp32 (q and k upcast), softmax normalised, then dropout.

Both mask scores with the optional ``(batch, s_k)`` key mask (1 =
attend) and the causal mask, give 0 for fully masked rows, and drop
probabilities AFTER normalisation with the same position hash
(:func:`hash_keep`, bit for bit the JAX ``_hash_keep``), so their keep
masks are equal.

Backward: the dq kernel and the dk/dv kernel, after delta = rowsum(do *
o) in fp32 (computed outside the kernels, as the JAX ``_bwd_call``
does), or their plain version :func:`attention_bwd_plain`, which keeps
``_bwd_call``'s numerics on whole matrices.

The bf16 kernels (forward, dq, dk/dv) run their products on the
tensor cores and take their tiles by 16-byte ``cp.async`` copies where
every row starts on a 16-byte boundary (the C entry decides, from the
pointers, strides and head_dim), by element loads otherwise; fp32 runs
on the CUDA cores. Each kernel puts one block per
tile of the sequence on the grid's y axis; past 65535 tiles the C entry
refuses the launch, and the wrapper raises CUDA's invalid-configuration
error.

Dispatch: on a CUDA tensor :func:`flash_attention` always launches the
kernels or raises (the JAX package's seq-256 crossover was a TPU v5e
tuning, and the port keeps no ``use_kernel`` switch); on a CPU tensor
it runs the plain versions.
"""

import ctypes
import math
from typing import Optional, Sequence, Tuple

import torch

from apex_tpu_torch.utils import prng
from apex_tpu_torch.utils.cuda_build import CudaLibrary, Kernel
from apex_tpu_torch.utils.platform import on_card

LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453
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
_F = ctypes.c_float
_STRIDES = ctypes.POINTER(_L)
FLASH_BWD_DQ = Kernel(LIB, "apx_flash_attention_bwd_dq",
                      [_P] * 8 + [_I] * 5 + [_STRIDES, _I, _I, _F, _F, _I,
                                             _F, _F, _U, _U, _U, _P])
FLASH_BWD_DKV = Kernel(LIB, "apx_flash_attention_bwd_dkv",
                       [_P] * 9 + [_I] * 5 + [_STRIDES, _I, _I, _F, _I, _F,
                                              _F, _U, _U, _U, _P])
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


def _keep_mask(b, h, sq, sk, seed, rate, dev) -> torch.Tensor:
    """(b, h, s_q, s_k) dropout keep mask at the global (b*h, q, k)
    positions, the kernels' mask bit for bit."""
    bh = torch.arange(b * h, device=dev).reshape(b, h, 1, 1)
    qpos = torch.arange(sq, device=dev).reshape(1, 1, sq, 1)
    kpos = torch.arange(sk, device=dev).reshape(1, 1, 1, sk)
    return hash_keep(qpos, kpos, bh, seed[0], seed[1], rate)


def _valid(q, k, mask, causal: bool) -> torch.Tensor:
    """(b or 1, 1, s_q or 1, s_k) bool: key mask and causal mask."""
    sq, sk = q.shape[2], k.shape[2]
    dev = q.device
    if mask is None:
        valid = torch.ones((1, 1, 1, sk), dtype=torch.bool, device=dev)
    else:
        valid = (mask != 0)[:, None, None, :]
    if causal:
        tri = torch.arange(sk, device=dev)[None, :] \
            <= torch.arange(sq, device=dev)[:, None]
        valid = valid & tri[None, None]
    return valid


def attention_probs(q, k, mask, *, causal: bool, scale: float
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Softmax probabilities (b, h, s_q, s_k) fp32 from fp32 scores (q
    and k upcast), 0 where masked and on fully masked rows, and the
    base-2 logsumexp (b*h, s_q), +inf on fully masked rows. The scores
    are normalised by ``torch.softmax`` with the masked ones at -1e30,
    as the serving caches' attentions normalise theirs
    (``models.gpt._cache_attention``, the paged plain versions): a
    masked key adds an exact 0, so a prompt's last row has the same
    bits in a one-shot prefill as in its final chunk."""
    b, h, sq, _ = q.shape
    dev = q.device
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    valid = _valid(q, k, mask, causal)
    s = torch.where(valid, s, torch.full((), _NEG, device=dev))
    live = valid.any(-1)
    p = torch.where(live[..., None], torch.softmax(s, dim=-1),
                    torch.zeros((), device=dev))
    lse = torch.where(live, torch.logsumexp(s, dim=-1) * LOG2E,
                      torch.full((), math.inf, device=dev))
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
        keep = _keep_mask(b, h, sq, sk, seed, rate, dev)
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


def attention_bwd_plain(q, k, v, mask, o, lse, do, seed: Sequence[int], *,
                        causal: bool, scale: float, rate: float
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the backward kernels: the JAX ``_bwd_call`` on
    whole matrices, with its numerics. q is prescaled by scale * log2(e)
    in fp32 and rounded once; p = exp2(s - lse) from the forward's
    base-2 lse (0 where masked and on fully masked rows); p and ds are
    rounded to the value dtype before their products; the dropout keep
    mask scales dp (divided by 1 - rate) and p (times the rounded 1 / (1
    - rate)); dq is multiplied by ``scale`` and dk by ln 2 once at the
    end. Returns (dq, dk, dv) in q's dtype."""
    b, h, sq, _ = q.shape
    sk = k.shape[2]
    dev = q.device
    dt = q.dtype
    qs = (q.float() * (scale * LOG2E)).to(dt).float()
    s = torch.matmul(qs, k.float().transpose(-1, -2))
    p = torch.where(_valid(q, k, mask, causal),
                    torch.exp2(s - lse.reshape(b, h, sq, 1)),
                    torch.zeros((), device=dev))
    dof = do.float()
    delta = (dof * o.float()).sum(-1, keepdim=True)
    dp = torch.matmul(dof, v.float().transpose(-1, -2))
    pd = p.to(dt)
    if rate > 0.0:
        keep = _keep_mask(b, h, sq, sk, seed, rate, dev)
        zero = torch.zeros((), device=dev)
        dp = torch.where(keep, dp / (1.0 - rate), zero)
        pd = torch.where(keep, pd * torch.tensor(1.0 / (1.0 - rate),
                                                 dtype=dt), zero.to(dt))
    ds = (p * (dp - delta)).to(dt).float()
    dq = torch.matmul(ds, k.float()).to(dt)
    dq = (dq.float() * scale).to(dt)
    dk = torch.matmul(ds.transpose(-1, -2), qs).to(dt)
    dk = (dk.float() * LN2).to(dt)
    dv = torch.matmul(pd.float().transpose(-1, -2), dof).to(dt)
    return dq, dk, dv


def _check_qkv(q, k, v, mask):
    """Checks the kernels' q, k, v (and mask); returns (b, h, s_q, s_k,
    d, mask as contiguous int32 or None)."""
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
    if sk < 1:
        raise RuntimeError(f"flash kernel: unsupported s_q={sq}, s_k={sk}")
    if mask is not None:
        if mask.shape != (b, sk) or mask.device != q.device:
            raise RuntimeError(f"mask must be ({b}, {sk}) on {q.device}, "
                               f"got {tuple(mask.shape)} on {mask.device}")
        mask = mask.to(torch.int32).contiguous()
    return b, h, sq, sk, d, mask


def _dropout_args(rate: float, seed: Sequence[int], dtype):
    """(dropout on, 1/(1-rate) rounded to the value dtype, 1 - rate,
    threshold, seed words) as the kernels take them."""
    drop_scale = 1.0
    if rate > 0.0:
        drop_scale = torch.tensor(1.0 / (1.0 - rate)).to(dtype).item()
    return (int(rate > 0.0), float(drop_scale), float(1.0 - rate),
            _threshold(rate), int(seed[0]) & _M32, int(seed[1]) & _M32)


_U = 2.0 ** -24   # fp32 unit roundoff


def bwd_limits(q, k, v, mask, o, lse, do, dq0, dk0, dv0, *, causal: bool,
               scale: float, rate: float
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """How far, per element, the backward kernels' (dq, dk, dv) may sit
    from :func:`attention_bwd_plain`'s (``dq0``, ``dk0``, ``dv0``) on
    the same inputs.

    Both sides start from the same prescaled q, lse and delta inputs and
    differ in the order of their fp32 sums. A sum of n terms taken in
    two orders differs by at most 2 (n - 1) u sum|terms| (u = 2^-24), so
    a score moves by ds = 2 d u (|q~| |k|^T) and dp by 2 d u (|do|
    |v|^T) / (1 - rate); p = exp2(s - lse) then moves by p (ln 2 ds +
    4 u), and ds = p (dp - delta) by that times |dp - delta| plus p
    times the dp and delta shifts. In bf16 each side also rounds p and ds
    to bf16 from these slightly different fp32 values, so each may land
    one ulp apart: 2^-7 |p| and 2^-7 |ds| more. These shifts are carried
    through the products (dq = scale * ds k, dk = ln 2 * ds^T q~, dv =
    p_drop^T do), whose own sums over keys or queries add the sum-order
    bound again; each rounding of an output to bf16 adds one ulp of the
    plain value (dq and dk are rounded twice, dv once; fp32: 4 u)."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    dev = q.device
    bf = q.dtype == torch.bfloat16
    qp = (q.float() * (scale * LOG2E)).to(q.dtype).float()
    qs, ka, va, doa = (t.float().abs() for t in (qp, k, v, do))
    keep = 1.0 / (1.0 - rate)
    s_abs = torch.matmul(qs, ka.transpose(-1, -2))  # sum of |terms| of s
    p = torch.where(_valid(q, k, mask, causal),
                    torch.exp2(torch.matmul(qp, k.float().transpose(-1, -2))
                               - lse.reshape(b, h, sq, 1)),
                    torch.zeros((), device=dev))
    dof = do.float()
    delta = (dof * o.float()).sum(-1, keepdim=True)
    dp = torch.matmul(dof, v.float().transpose(-1, -2)) * keep
    ds = p * (dp - delta)
    e_dp = 2 * d * _U * keep * torch.matmul(doa, va.transpose(-1, -2))
    e_delta = 2 * d * _U * (doa * o.float().abs()).sum(-1, keepdim=True)
    e_p = p * (LN2 * 2 * d * _U * s_abs + 4 * _U)
    e_ds = e_p * (dp - delta).abs() + p * (e_dp + e_delta)
    e_pd = e_p * keep
    if bf:  # p_drop is rounded twice under dropout (p, then p * scale)
        e_ds = e_ds + 2.0 ** -7 * ds.abs()
        e_pd = e_pd + (2.0 ** -6 if rate > 0.0 else 2.0 ** -7) * p * keep
    dsa, pa = ds.abs(), p * keep
    lim_dq = scale * (torch.matmul(e_ds, ka)
                      + 2 * sk * _U * torch.matmul(dsa, ka))
    lim_dk = LN2 * (torch.matmul(e_ds.transpose(-1, -2), qs)
                    + 2 * sq * _U * torch.matmul(dsa.transpose(-1, -2), qs))
    lim_dv = (torch.matmul(e_pd.transpose(-1, -2), doa)
              + 2 * sq * _U * torch.matmul(pa.transpose(-1, -2), doa))
    ulp = 2.0 ** -7 if bf else 4 * _U
    return (lim_dq + 2 * ulp * dq0.float().abs(),
            lim_dk + 2 * ulp * dk0.float().abs(),
            lim_dv + ulp * dv0.float().abs())


def attention_fwd_kernel(q, k, v, mask, seed: Sequence[int], *,
                         causal: bool, scale: float, rate: float
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/flash_attention.cu``. q, k, v: CUDA (b, h, s, d),
    fp32 or bf16 alike, any strides with unit stride over d. Returns o
    (b, h, s_q, d) — laid out (b, s_q, h, d) in memory so that merging
    the heads back is free — and the base-2 lse (b*h, s_q) fp32."""
    b, h, sq, sk, d, mask = _check_qkv(q, k, v, mask)
    o = torch.empty((b, sq, h, d), device=q.device,
                    dtype=q.dtype).transpose(1, 2)
    lse = torch.empty((b * h, sq), device=q.device, dtype=torch.float32)
    if sq == 0 or b * h == 0:
        return o, lse
    dropout, drop_scale, _, thresh, lo, hi = _dropout_args(rate, seed,
                                                           q.dtype)
    FLASH_FWD(q.data_ptr(), k.data_ptr(), v.data_ptr(),
              None if mask is None else mask.data_ptr(), o.data_ptr(),
              lse.data_ptr(), b, h, sq, sk, d,
              q.stride(0), q.stride(1), q.stride(2),
              k.stride(0), k.stride(1), k.stride(2),
              v.stride(0), v.stride(1), v.stride(2),
              o.stride(0), o.stride(1), o.stride(2),
              _DTYPE_CODE[q.dtype], int(causal), float(scale * LOG2E),
              dropout, drop_scale, thresh, lo, hi,
              torch.cuda.current_stream(q.device).cuda_stream)
    return o, lse


def _empty_like_heads(t: torch.Tensor) -> torch.Tensor:
    """(b, h, s, d) laid out (b, s, h, d) in memory, like the forward's
    o: the gradient of a head split of a (b, s, h*d) projection."""
    b, h, s, d = t.shape
    return torch.empty((b, s, h, d), device=t.device,
                       dtype=t.dtype).transpose(1, 2)


def _check_bwd(q, do, lse, delta) -> None:
    b, h, sq, d = q.shape
    if do.shape != q.shape or do.dtype != q.dtype \
            or do.device != q.device or do.stride(-1) != 1:
        raise RuntimeError(f"flash backward needs do like q {tuple(q.shape)}"
                           f" {q.dtype} with unit stride over head_dim, got "
                           f"{tuple(do.shape)} {do.dtype}")
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != (b * h, sq) or t.dtype != torch.float32 \
                or t.device != q.device or not t.is_contiguous():
            raise RuntimeError(f"flash backward needs a contiguous fp32 "
                               f"({b * h}, {sq}) {name} on {q.device}")


def _strides(*ts) -> ctypes.Array:
    vals = []
    for t in ts:
        vals += [t.stride(0), t.stride(1), t.stride(2)] if t is not None \
            else [0, 0, 0]
    return (_L * len(vals))(*vals)


def attention_dq_kernel(q, k, v, mask, do, lse, delta,
                        seed: Sequence[int], *, causal: bool, scale: float,
                        rate: float) -> torch.Tensor:
    """Launch the dq kernel of ``csrc/flash_attention.cu`` (the JAX
    ``_dq_kernel``). ``lse``: the forward's base-2 lse; ``delta``:
    rowsum(do * o) in fp32, both (b*h, s_q). Returns dq (b, h, s_q, d),
    laid out (b, s_q, h, d)."""
    b, h, sq, sk, d, mask = _check_qkv(q, k, v, mask)
    _check_bwd(q, do, lse, delta)
    dq = _empty_like_heads(q)
    if sq == 0 or b * h == 0:
        return dq
    dropout, drop_scale, keep_prob, thresh, lo, hi = _dropout_args(
        rate, seed, q.dtype)
    FLASH_BWD_DQ(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 None if mask is None else mask.data_ptr(), do.data_ptr(),
                 lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
                 b, h, sq, sk, d, _strides(q, k, v, do, dq, None, None),
                 _DTYPE_CODE[q.dtype], int(causal), float(scale * LOG2E),
                 float(scale), dropout, drop_scale, keep_prob, thresh, lo,
                 hi, torch.cuda.current_stream(q.device).cuda_stream)
    return dq


def attention_dkv_kernel(q, k, v, mask, do, lse, delta,
                         seed: Sequence[int], *, causal: bool, scale: float,
                         rate: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the dk/dv kernel of ``csrc/flash_attention.cu`` (the JAX
    ``_dkv_kernel``); arguments as :func:`attention_dq_kernel`. Returns
    (dk, dv), each (b, h, s_k, d) laid out (b, s_k, h, d)."""
    b, h, sq, sk, d, mask = _check_qkv(q, k, v, mask)
    _check_bwd(q, do, lse, delta)
    dk, dv = _empty_like_heads(k), _empty_like_heads(v)
    if sk == 0 or b * h == 0:
        return dk, dv
    dropout, drop_scale, keep_prob, thresh, lo, hi = _dropout_args(
        rate, seed, q.dtype)
    FLASH_BWD_DKV(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  None if mask is None else mask.data_ptr(), do.data_ptr(),
                  lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
                  dv.data_ptr(), b, h, sq, sk, d,
                  _strides(q, k, v, do, None, dk, dv),
                  _DTYPE_CODE[q.dtype], int(causal), float(scale * LOG2E),
                  dropout, drop_scale, keep_prob, thresh, lo, hi,
                  torch.cuda.current_stream(q.device).cuda_stream)
    return dk, dv


def attention_bwd_kernel(q, k, v, mask, o, lse, do, seed: Sequence[int], *,
                         causal: bool, scale: float, rate: float
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """delta = rowsum(do * o) in fp32, then the dq and dk/dv kernels."""
    delta = (do.float() * o.float()).sum(-1).reshape(-1, q.shape[2])
    kw = dict(causal=causal, scale=scale, rate=rate)
    dq = attention_dq_kernel(q, k, v, mask, do, lse, delta, seed, **kw)
    dk, dv = attention_dkv_kernel(q, k, v, mask, do, lse, delta, seed, **kw)
    return dq, dk, dv


class _Flash(torch.autograd.Function):
    """Forward kernel (CUDA) or plain version (CPU); the backward runs
    the dq and dk/dv kernels (CUDA) or their plain version (CPU) from
    the saved o and base-2 lse."""

    @staticmethod
    def forward(ctx, q, k, v, mask, seed, causal, scale, rate):
        fwd = attention_fwd_kernel if on_card(q, "q") else attention_fwd_plain
        o, lse = fwd(q, k, v, mask, seed, causal=causal, scale=scale,
                     rate=rate)
        ctx.save_for_backward(q, k, v, mask, o, lse)
        ctx.cfg = (seed, dict(causal=causal, scale=scale, rate=rate))
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, mask, o, lse = ctx.saved_tensors
        seed, kw = ctx.cfg
        if do.stride(-1) != 1:
            do = do.contiguous()
        bwd = attention_bwd_kernel if on_card(q, "q") else attention_bwd_plain
        dq, dk, dv = bwd(q, k, v, mask, o, lse, do, seed, **kw)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask: Optional[torch.Tensor] = None, *,
                    causal: bool = False,
                    softmax_scale: Optional[float] = None,
                    dropout_rate: float = 0.0,
                    dropout_rng=None) -> torch.Tensor:
    """Scaled-dot-product attention.

    Args:
      q, k, v: (batch, heads, seq, head_dim).
      mask: optional (batch, s_k) with 1 = attend.
      causal: apply the implicit upper-triangular mask.
      softmax_scale: defaults to 1/sqrt(head_dim).
      dropout_rate: probability dropout after normalisation; active
        only when ``dropout_rng`` is given.
      dropout_rng: a ``utils.prng`` key; its ``bits(key, (2,))`` seed
        the position hash, as in the JAX function. Drawn on the host:
        the kernels take the two words as launch arguments.

    Returns (batch, heads, seq, head_dim) in q's dtype.
    """
    if softmax_scale is None:
        softmax_scale = 1.0 / (q.shape[-1] ** 0.5)
    rate = float(dropout_rate) if dropout_rng is not None else 0.0
    seed = prng.host_bits(dropout_rng, 2) if rate > 0.0 else (0, 0)
    return _Flash.apply(q, k, v, mask, seed, bool(causal),
                        float(softmax_scale), rate)

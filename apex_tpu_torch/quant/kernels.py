"""Dequant-fused int8 weight-only matmuls (counterpart of
``apex_tpu/quant/kernels.py``).

Per-output-channel symmetric int8 weights halve the bf16 parameter read
of a decode step; the int8 weights are dequantized on the fly
(``float(wq) * scale``, fp32) into an fp32-accumulated product, so
device memory only ever holds the int8 copy and an fp32 scale vector.

Two weight layouts, one contract:

- ``w8_matmul``: activations ``(..., K)`` against ``wq (K, N)`` with
  ``scale (N,)`` and an optional ``bias (N,)`` added in fp32;
- ``w8_matmul_nk``: ``wq (N, K)`` row-major over output channels: the
  tied-embedding logits head ``hidden @ table.T`` without a transposed
  copy of the int8 table.

Dispatch: a CUDA tensor launches the hand-written kernels
(``csrc/w8_matmul.cu``; ``W8_MATMUL`` with a bias, ``W8_MATMUL_NOBIAS``
without, ``W8_MATMUL_NK``) or raises; a CPU tensor takes the plain
versions below, which dequantize in fp32 and take one fp32 product.
The two sum the K products in other orders (a bf16 x on the tensor
cores, KN at M > 8 and NK at M <= 8, with the scale applied after the
sum), and are held to each other by ``w8_limit``.
"""

import ctypes
import math
from typing import Optional

import torch

from apex_tpu_torch.utils.cuda_build import CudaLibrary, Kernel
from apex_tpu_torch.utils.platform import on_card

LIB = CudaLibrary("w8_matmul")
_P = ctypes.c_void_p
_I = ctypes.c_int
W8_MATMUL = Kernel(LIB, "apx_w8_matmul", [_P] * 7 + [_I] * 6 + [_P])
W8_MATMUL_NOBIAS = Kernel(LIB, "apx_w8_matmul_nobias",
                          [_P] * 6 + [_I] * 5 + [_P])
W8_MATMUL_NK = Kernel(LIB, "apx_w8_matmul_nk", [_P] * 5 + [_I] * 5 + [_P])
_IO_DTYPES = (torch.float32, torch.bfloat16)
_U = 2.0 ** -24      # fp32 unit roundoff
_BF16_ULP = 2.0 ** -7


def _name(dt: torch.dtype) -> str:
    return str(dt).replace("torch.", "")


def _check_operands(x, wq, scale, k: int, n: int) -> None:
    """The JAX package's operand checks, with its messages."""
    if wq.dtype != torch.int8:
        raise ValueError(f"wq must be int8, got {_name(wq.dtype)}")
    if scale.dtype != torch.float32:
        raise ValueError(f"scale must be fp32, got {_name(scale.dtype)}")
    if tuple(scale.shape) != (n,):
        raise ValueError(f"scale {tuple(scale.shape)} != per-output-channel "
                         f"({n},)")
    if x.shape[-1] != k:
        raise ValueError(f"x last dim {x.shape[-1]} != contraction {k}")


def _dequant(wq: torch.Tensor, scale: torch.Tensor, nk: bool
             ) -> torch.Tensor:
    return wq.float() * (scale[:, None] if nk else scale[None, :])


def w8_matmul_plain(x2: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor,
                    bias: Optional[torch.Tensor],
                    out_dtype: torch.dtype) -> torch.Tensor:
    """Plain version of the KN kernels on ``x2 (M, K)``: dequantize in
    fp32, one fp32 product, the bias added in fp32, one cast."""
    y = torch.matmul(x2.float(), _dequant(wq, scale, False))
    if bias is not None:
        y = y + bias.float()
    return y.to(out_dtype)


def w8_matmul_nk_plain(x2: torch.Tensor, wq: torch.Tensor,
                       scale: torch.Tensor,
                       out_dtype: torch.dtype) -> torch.Tensor:
    """Plain version of the NK kernel on ``x2 (M, K)``."""
    return torch.matmul(x2.float(),
                        _dequant(wq, scale, True).t()).to(out_dtype)


def _check_launch(who: str, x2, wq, scale, bias, out_dtype) -> None:
    if x2.device.type != "cuda":
        raise RuntimeError(f"{who} kernel needs CUDA tensors, got x on "
                           f"{x2.device}")
    if x2.dtype not in _IO_DTYPES or out_dtype not in _IO_DTYPES:
        raise RuntimeError(f"{who} kernel takes and gives fp32 or bf16, got "
                           f"x {x2.dtype}, out {out_dtype}")
    if x2.dim() != 2 or x2.shape[1] == 0:
        raise RuntimeError(f"{who} kernel needs a 2-d x with a "
                           "non-empty contraction")
    for name, t in (("x", x2), ("wq", wq), ("scale", scale),
                    ("bias", bias)):
        if t is not None and (t.device != x2.device
                              or not t.is_contiguous()):
            raise RuntimeError(f"{who} kernel needs a contiguous {name} on "
                               f"{x2.device}, got one on {t.device}")
    if bias is not None and (bias.dtype not in _IO_DTYPES
                             or tuple(bias.shape) != (scale.shape[0],)):
        raise RuntimeError(f"{who} kernel needs an fp32 or bf16 "
                           f"({scale.shape[0]},) bias, got "
                           f"{tuple(bias.shape)} {bias.dtype}")


def _plan_size(symbol: str, m: int, k: int, n: int, nk: bool,
               x_bf16: int) -> int:
    fn = getattr(LIB.load(), symbol)
    fn.argtypes = [_I] * 5
    fn.restype = ctypes.c_longlong
    return fn(m, k, n, int(nk), x_bf16)


def _workspace(m: int, k: int, n: int, nk: bool, x_bf16: int,
               dev) -> torch.Tensor:
    """The fp32 scratch for the kernel's K parts (the C side's plan)."""
    return torch.empty((_plan_size("apx_w8_workspace", m, k, n, nk,
                                   x_bf16),),
                       dtype=torch.float32, device=dev)


_COUNTERS = {}


def _counters(m: int, k: int, n: int, x_bf16: int, dev) -> torch.Tensor:
    """The arrival counters of a split-K launch: a zeroed int32 buffer
    kept per device and grown as needed. Each launch finds its counters
    zero and leaves them zero (the last block of a tile or strip resets
    its own), so one buffer serves every launch on the device, CUDA-graph
    replays included; launches that split K must not run concurrently on
    two streams of one device."""
    need = _plan_size("apx_w8_counters", m, k, n, False, x_bf16)
    key = dev.index if dev.index is not None else torch.cuda.current_device()
    buf = _COUNTERS.get(key)
    if buf is None or buf.numel() < need:
        buf = torch.zeros((max(need, 1024),), dtype=torch.int32, device=dev)
        _COUNTERS[key] = buf
    return buf


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None or t.numel() == 0 else t.data_ptr()


def _bf16(t: torch.Tensor) -> int:
    return int(t.dtype == torch.bfloat16)


def w8_matmul_kernel(x2: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor,
                     bias: Optional[torch.Tensor],
                     out_dtype: torch.dtype) -> torch.Tensor:
    """Launch ``apx_w8_matmul`` (or ``apx_w8_matmul_nobias``) on CUDA
    tensors: ``x2 (M, K) @ dequant(wq (K, N)) [+ bias]``. Raises on
    anything the kernels do not take."""
    who = "w8_matmul"
    k, n = wq.shape
    _check_operands(x2, wq, scale, k, n)
    _check_launch(who, x2, wq, scale, bias, out_dtype)
    m = x2.shape[0]
    out = torch.empty((m, n), dtype=out_dtype, device=x2.device)
    if m == 0 or n == 0:
        return out
    work = _workspace(m, k, n, False, _bf16(x2), x2.device)
    counters = _counters(m, k, n, _bf16(x2), x2.device)
    stream = torch.cuda.current_stream(x2.device).cuda_stream
    if bias is None:
        W8_MATMUL_NOBIAS(x2.data_ptr(), wq.data_ptr(), scale.data_ptr(),
                         out.data_ptr(), _ptr(work), counters.data_ptr(), m,
                         k, n, _bf16(x2), _bf16(out), stream)
    else:
        W8_MATMUL(x2.data_ptr(), wq.data_ptr(), scale.data_ptr(),
                  bias.data_ptr(), out.data_ptr(), _ptr(work),
                  counters.data_ptr(), m, k, n, _bf16(x2), _bf16(out),
                  _bf16(bias), stream)
    return out


def w8_matmul_nk_kernel(x2: torch.Tensor, wq: torch.Tensor,
                        scale: torch.Tensor,
                        out_dtype: torch.dtype) -> torch.Tensor:
    """Launch ``apx_w8_matmul_nk`` on CUDA tensors: ``x2 (M, K) @
    dequant(wq (N, K)).T``. Raises on anything the kernel does not
    take."""
    who = "w8_matmul_nk"
    n, k = wq.shape
    _check_operands(x2, wq, scale, k, n)
    _check_launch(who, x2, wq, scale, None, out_dtype)
    m = x2.shape[0]
    out = torch.empty((m, n), dtype=out_dtype, device=x2.device)
    if m == 0 or n == 0:
        return out
    work = _workspace(m, k, n, True, _bf16(x2), x2.device)
    W8_MATMUL_NK(x2.data_ptr(), wq.data_ptr(), scale.data_ptr(),
                 out.data_ptr(), _ptr(work), m, k, n, _bf16(x2), _bf16(out),
                 torch.cuda.current_stream(x2.device).cuda_stream)
    return out


def w8_matmul(x: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor,
              bias: Optional[torch.Tensor] = None,
              out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``x (..., K) @ dequant(wq (K, N), scale (N,)) [+ bias (N,)]``.

    fp32 accumulation, output in ``out_dtype`` (default: ``x.dtype``).
    """
    k, n = wq.shape
    _check_operands(x, wq, scale, k, n)
    out_dtype = x.dtype if out_dtype is None else out_dtype
    lead = tuple(x.shape[:-1])
    x2 = x.reshape(math.prod(lead), k).contiguous()
    fn = w8_matmul_kernel if on_card(x, "x") else w8_matmul_plain
    return fn(x2, wq, scale, bias, out_dtype).reshape(lead + (n,))


def w8_matmul_nk(x: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor,
                 out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``x (..., K) @ dequant(wq (N, K), scale (N,)).T``: the logits head
    against the output-channel-major int8 word table. fp32 out by
    default (the logits contract)."""
    n, k = wq.shape
    _check_operands(x, wq, scale, k, n)
    lead = tuple(x.shape[:-1])
    x2 = x.reshape(math.prod(lead), k).contiguous()
    fn = w8_matmul_nk_kernel if on_card(x, "x") else w8_matmul_nk_plain
    return fn(x2, wq, scale, out_dtype).reshape(lead + (n,))


def w8_limit(x: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor,
             bias: Optional[torch.Tensor] = None,
             out_dtype: Optional[torch.dtype] = None,
             nk: bool = False) -> torch.Tensor:
    """How far, per element, one w8 product may sit from another on the
    same inputs (kernel against plain version, or the port against the
    JAX package), shaped like the output.

    Each side stays within K u sum_k |x_k| |w_kn| of the exact sum (u =
    2^-24), so two of them within twice that:

    - The plain versions and the CUDA-core kernels dequantize each weight
      to the same fp32 w = fl(q s) and sum the K fp32 products x w in
      some order: each product and each of the K - 1 additions rounds
      once.
    - The tensor-core kernels (bf16 x: KN at M > 8, NK at M <= 8, in
      another k order inside each step) compute s_n sum_k (x_k
      q_kn): each product is exact (8 significant bits times |q| <=
      127), the K - 1 fp32 additions each round by at most u of a
      partial sum's magnitude, and the factored scale adds one rounding,
      u |y| <= u sum |x| |w|; against the exact sum of the exact
      dequantized weights q s it also skips the rounding of q s, which
      only removes error.

    Adding the bias rounds once on each side (2 u of the sum of the
    magnitudes). A bf16 output (``out_dtype``; default x's, fp32 for
    ``nk``) adds one ulp of the value: both sides round their fp32 sums
    once, 2^-7 of |y| plus that fp32 limit."""
    k = wq.shape[1] if nk else wq.shape[0]
    if out_dtype is None:
        out_dtype = torch.float32 if nk else x.dtype
    lead = tuple(x.shape[:-1])
    x2 = x.reshape(math.prod(lead), k).float()
    w = _dequant(wq, scale, nk)
    w = w.t() if nk else w
    mag = torch.matmul(x2.abs(), w.abs())
    y = torch.matmul(x2, w)
    if bias is not None:
        mag = mag + bias.float().abs()
        y = y + bias.float()
    lim = 2 * k * _U * mag + 2 * _U * mag
    if out_dtype == torch.bfloat16:
        lim = lim + _BF16_ULP * (y.abs() + lim)
    return (lim + 2.0 ** -126).reshape(lead + (w.shape[1],))

"""Single-query attention against a paged KV pool, reading K and V
through each slot's block table: the attention of one decode step over
``serving.cache.PagedKVCache``, after the step has written its new row.

The JAX package computes it as plain XLA inside
``apex_tpu/models/gpt.py``'s ``_paged_decode_attention`` (:403) and
``_paged_decode_attention_q8`` (:951): it gathers each slot's whole
block-table row out of the pool (``k_pages[block_tables]``), upcasts it
to fp32 (dequantizes an int8 pool against its per-page-per-head scales),
takes fp32 scores over the logical positions, sets those past ``pos`` to
``finfo(f32).min`` (probability exactly 0), and takes the fp32 softmax
and the fp32 product with V, cast to q's dtype. Two versions of that
function:

- the kernel (``csrc/paged_attention.cu``): walks each slot's logical
  positions ``0..pos`` only, reading each row's physical page from the
  table, with an online softmax in fp32 in an order fixed by logical
  position — the same logical contents under any page placement give
  the same bits;
- the plain version, the JAX function's gather, upcast, mask, softmax
  and product in its order of operations.

They sum in other orders and are held to each other by
:func:`paged_limit`. Dispatch: a CUDA tensor launches the kernel
(``PAGED_DECODE``) or raises; a CPU tensor runs the plain version.
"""

import ctypes
import math
from typing import Optional

import torch

from apex_tpu_torch.utils.cuda_build import CudaLibrary, Kernel
from apex_tpu_torch.utils.platform import on_card

LIB = CudaLibrary("paged_attention")
_P = ctypes.c_void_p
_I = ctypes.c_int
PAGED_DECODE = Kernel(LIB, "apx_paged_decode_attention",
                      [_P] * 8 + [_I] * 7 + [ctypes.c_float, _P])
_Q_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KV_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_U = 2.0 ** -24      # fp32 unit roundoff


def _name(dt: torch.dtype) -> str:
    return str(dt).replace("torch.", "")


def _check(q, k_pages, v_pages, block_tables, pos, k_scale, v_scale):
    """Shapes and dtypes; returns (b, nh, page, hd, max_pages)."""
    if q.dim() != 3:
        raise ValueError(f"q must be (b, nh, hd), got {tuple(q.shape)}")
    b, nh, hd = q.shape
    if q.dtype not in _Q_DTYPES:
        raise ValueError(f"q must be fp32 or bf16, got {_name(q.dtype)}")
    if k_pages.dim() != 4 or k_pages.shape != v_pages.shape:
        raise ValueError(
            f"k_pages {tuple(k_pages.shape)} and v_pages "
            f"{tuple(v_pages.shape)} must be one (num_pages, nh, page, hd)")
    num_pages, pnh, page, phd = k_pages.shape
    if (pnh, phd) != (nh, hd):
        raise ValueError(f"pool heads/head_dim ({pnh}, {phd}) != q's "
                         f"({nh}, {hd})")
    if k_pages.dtype not in _KV_DTYPES or v_pages.dtype != k_pages.dtype:
        raise ValueError(f"pools must be one of fp32, bf16, int8, got "
                         f"{_name(k_pages.dtype)}/{_name(v_pages.dtype)}")
    quant = k_pages.dtype == torch.int8
    if quant != (k_scale is not None) or (k_scale is None) != (
            v_scale is None):
        raise ValueError("an int8 pool needs k_scale and v_scale, and only "
                         "an int8 pool takes them")
    if quant:
        for s in (k_scale, v_scale):
            if s.dtype != torch.float32 or tuple(s.shape) != (num_pages,
                                                              nh):
                raise ValueError(
                    f"scales must be fp32 (num_pages, nh) = "
                    f"{(num_pages, nh)}, got {_name(s.dtype)} "
                    f"{tuple(s.shape)}")
    if block_tables.dim() != 2 or block_tables.shape[0] != b \
            or block_tables.dtype != torch.int32:
        raise ValueError(f"block_tables must be int32 ({b}, max_pages), "
                         f"got {_name(block_tables.dtype)} "
                         f"{tuple(block_tables.shape)}")
    if tuple(pos.shape) != (b,) or pos.dtype != torch.int32:
        raise ValueError(f"pos must be int32 ({b},), got "
                         f"{_name(pos.dtype)} {tuple(pos.shape)}")
    return b, nh, page, hd, block_tables.shape[1]


def _scale(hd: int, softmax_scale: Optional[float]) -> float:
    return 1.0 / math.sqrt(hd) if softmax_scale is None else softmax_scale


def _gather(pool, scale, block_tables):
    """(b, nh, S, hd) fp32 view of each slot's table row, S = max_pages
    * page (an int8 pool dequantized against its gathered scales)."""
    g = pool[block_tables.long()]              # (b, mp, nh, page, hd)
    if scale is not None:
        g = g.float() * scale[block_tables.long()].float()[..., None, None]
    g = g.float().transpose(1, 2)
    b, nh, mp, page, hd = g.shape
    return g.reshape(b, nh, mp * page, hd)


def _probs(q, kg, pos, softmax_scale):
    """The plain version's fp32 probabilities (b, nh, S): scores
    divided by sqrt(hd) (or times ``softmax_scale``), ``finfo.min`` past
    ``pos``, softmax."""
    hd = q.shape[-1]
    scores = torch.matmul(q.float()[:, :, None, :],
                          kg.transpose(-1, -2))[:, :, 0]
    scores = scores / math.sqrt(hd) if softmax_scale is None \
        else scores * softmax_scale
    valid = torch.arange(kg.shape[2], device=q.device)[None, None, :] \
        <= pos[:, None, None]
    scores = torch.where(valid, scores, torch.finfo(torch.float32).min)
    return torch.softmax(scores, dim=-1)


def paged_decode_attention_plain(q, k_pages, v_pages, block_tables, pos,
                                 k_scale=None, v_scale=None,
                                 softmax_scale=None) -> torch.Tensor:
    """Plain version: the JAX ``_paged_decode_attention`` after its write
    — gather the whole table row, upcast (dequantize), fp32 scores over
    the logical positions masked to ``s <= pos`` with ``finfo.min``,
    fp32 softmax and product with V, one cast to q's dtype."""
    _check(q, k_pages, v_pages, block_tables, pos, k_scale, v_scale)
    kg = _gather(k_pages, k_scale, block_tables)
    vg = _gather(v_pages, v_scale, block_tables)
    probs = _probs(q, kg, pos, softmax_scale)
    return torch.matmul(probs[:, :, None, :], vg)[:, :, 0].to(q.dtype)


def paged_limit(q, k_pages, v_pages, block_tables, pos, ctx0,
                k_scale=None, v_scale=None,
                softmax_scale=None) -> torch.Tensor:
    """How far, per element, the kernel's ctx may sit from the plain
    version's ``ctx0`` on the same inputs. Both take the same fp32
    inputs (bf16 widens exactly; an int8 row is dequantized by the same
    one multiply) and differ in the order of their sums. With u =
    2^-24, D the largest scaled sum over a slot's live rows of
    |q_e k_e|, A = sum_j p_j |v_j| and n = pos + 1 live rows of S =
    max_pages * page:

    - a score's rounding, up to 2 hd u D on both sides, and the exps'
      and the normalisation's few u move each p_j by a relative (2 hd D
      + 8) u, and ctx by that times (A + |ctx|);
    - the sums over the rows add at most (n + S + 32) u A (a sequential
      sum's worst case on each side);
    - a bf16 ctx is rounded once on each side: one bf16 ulp more,
      2^-7 |ctx0|."""
    b, nh, page, hd, mp = _check(q, k_pages, v_pages, block_tables, pos,
                                 k_scale, v_scale)
    kg = _gather(k_pages, k_scale, block_tables)
    vg = _gather(v_pages, v_scale, block_tables)
    s_len = mp * page
    scale = abs(_scale(hd, softmax_scale))
    valid = torch.arange(s_len, device=q.device)[None, None, :] \
        <= pos[:, None, None]
    dots = torch.matmul(q.float().abs()[:, :, None, :],
                        kg.abs().transpose(-1, -2))[:, :, 0] * scale
    d_max = torch.where(valid, dots, torch.zeros((), device=q.device)
                        ).amax(-1)                         # (b, nh)
    a = torch.matmul(_probs(q, kg, pos, softmax_scale)[:, :, None, :],
                     vg.abs())[:, :, 0]                    # (b, nh, hd)
    n = torch.clamp(pos.long() + 1, max=s_len).float()[:, None, None]
    o = ctx0.float().abs()
    lim = _U * ((2 * hd * d_max + 8)[..., None] * (a + o)
                + (n + s_len + 32) * a)
    if q.dtype == torch.bfloat16:
        lim = lim + 2.0 ** -7 * o
    return lim


def paged_decode_attention_kernel(q, k_pages, v_pages, block_tables, pos,
                                  k_scale=None, v_scale=None,
                                  softmax_scale=None) -> torch.Tensor:
    """Launch ``csrc/paged_attention.cu``. Every tensor on one CUDA
    device and contiguous; returns ctx (b, nh, hd) in q's dtype."""
    b, nh, page, hd, mp = _check(q, k_pages, v_pages, block_tables, pos,
                                 k_scale, v_scale)
    ts = [q, k_pages, v_pages, block_tables, pos] + (
        [k_scale, v_scale] if k_scale is not None else [])
    if any(t.device != q.device or t.device.type != "cuda" for t in ts):
        raise RuntimeError("paged_decode_attention kernel needs CUDA "
                           "tensors on one device")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("paged_decode_attention kernel needs contiguous "
                         "q, pools, scales, block_tables and pos")
    out = torch.empty_like(q)
    PAGED_DECODE(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                 None if k_scale is None else k_scale.data_ptr(),
                 None if v_scale is None else v_scale.data_ptr(),
                 block_tables.data_ptr(), pos.data_ptr(), out.data_ptr(),
                 b, nh, page, hd, mp, _Q_DTYPES[q.dtype],
                 _KV_DTYPES[k_pages.dtype], float(_scale(hd, softmax_scale)),
                 torch.cuda.current_stream(q.device).cuda_stream)
    return out


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor,
                           block_tables: torch.Tensor, pos: torch.Tensor,
                           k_scale: Optional[torch.Tensor] = None,
                           v_scale: Optional[torch.Tensor] = None,
                           softmax_scale: Optional[float] = None
                           ) -> torch.Tensor:
    """ctx (b, nh, hd) in q's dtype: q (b, nh, hd) fp32 or bf16 against
    one layer's pools (num_pages, nh, page, hd) fp32, bf16 or int8 (with
    (num_pages, nh) fp32 scales), over each slot's logical positions
    ``0..pos`` through ``block_tables`` (b, max_pages) int32. The scale
    is ``1 / sqrt(hd)`` unless given. A CUDA q launches the kernel; a CPU
    q runs the plain version."""
    fn = paged_decode_attention_kernel if on_card(q, "q") \
        else paged_decode_attention_plain
    return fn(q, k_pages, v_pages, block_tables, pos, k_scale, v_scale,
              softmax_scale)

"""Attention against a paged KV pool, reading K and V through each
slot's block table: the attention of one decode step (one query a slot)
or one speculative verify step (k1 queries a slot) over
``serving.cache.PagedKVCache``, after the step has written its rows.

The JAX package computes it as plain XLA inside
``apex_tpu/models/gpt.py``: ``_paged_decode_attention`` (:403),
``_paged_verify_attention`` (:537), ``_paged_tree_verify_attention``
(:816) and the int8 forms ``_paged_decode_attention_q8`` (:951) and
``_paged_verify_attention_q8`` (:1004). It gathers each slot's whole
block-table row out of the pool (``k_pages[block_tables]``), upcasts it
to fp32 (dequantizes an int8 pool against its per-page-per-head
scales), takes fp32 scores over the logical positions, sets those a
query cannot see to ``finfo(f32).min`` (probability exactly 0), and
takes the fp32 softmax and the fp32 product with V, cast to q's dtype.
Query j of a slot at length ``pos`` sees row s when ``s < pos``, or when
``0 <= s - pos < k1`` and ``anc[s - pos, j]`` (``_tree_score_mask``,
:739); the linear verify is ``s <= pos + j``, the decode step ``s <=
pos``. Two versions of that function:

- the kernel (``csrc/paged_attention.cu``): reads the rows ``0 .. pos +
  k1 - 1`` once for all k1 queries, each row's physical page from the
  table, with an online softmax in fp32 a query in an order fixed by
  logical position — the same logical contents under any page placement
  give the same bits, and column j of a linear verify the bits of a
  decode step at ``pos + j``;
- the plain version, the JAX function's gather, upcast, mask, softmax
  and product in its order of operations.

They sum in other orders and are held to each other by
:func:`paged_limit`. Dispatch: a CUDA tensor launches the kernel
(``PAGED_DECODE`` for one query a slot, ``PAGED_VERIFY`` for k1) or
raises; a CPU tensor runs the plain version.
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
_ARGS = [_P] * 9 + [_I] * 8 + [ctypes.c_float, _P]
# one C entry; the two wrappers count their launches apart
PAGED_DECODE = Kernel(LIB, "apx_paged_attention", _ARGS)
PAGED_VERIFY = Kernel(LIB, "apx_paged_attention", _ARGS)
#: The most queries a slot the kernel holds (tree grids at spec_k up to
#: 31 with their forced chains); its C entry refuses more.
MAX_K1 = 64
_Q_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KV_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_U = 2.0 ** -24      # fp32 unit roundoff


def _name(dt: torch.dtype) -> str:
    return str(dt).replace("torch.", "")


def _check(q, k_pages, v_pages, block_tables, pos, k_scale, v_scale,
           anc=None, queries=False):
    """Shapes and dtypes; returns (b, nh, k1, page, hd, max_pages). q is
    (b, nh, hd) for one query a slot, (b, nh, k1, hd) with
    ``queries``."""
    want = 4 if queries else 3
    if q.dim() != want:
        raise ValueError(
            f"q must be {'(b, nh, k1, hd)' if queries else '(b, nh, hd)'},"
            f" got {tuple(q.shape)}")
    b, nh, hd = q.shape[0], q.shape[1], q.shape[-1]
    k1 = q.shape[2] if queries else 1
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
    if anc is not None and (anc.dtype != torch.bool
                            or tuple(anc.shape) != (b, k1, k1)):
        raise ValueError(f"anc must be bool ({b}, {k1}, {k1}), got "
                         f"{_name(anc.dtype)} {tuple(anc.shape)}")
    return b, nh, k1, page, hd, block_tables.shape[1]


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


def visible(pos: torch.Tensor, k1: int, s_len: int,
            anc: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(b, k1, s_len) bool: key row s visible to query j of slot b — the
    JAX ``_tree_score_mask``: ``s < pos``, or ``0 <= s - pos < k1`` and
    ``anc[b, s - pos, j]`` (``s - pos <= j`` without ``anc``)."""
    s_idx = torch.arange(s_len, device=pos.device)
    rel = s_idx[None, :] - pos.long()[:, None]            # (b, s)
    committed = rel < 0
    in_win = (rel >= 0) & (rel < k1)
    relc = rel.clamp(0, k1 - 1)
    if anc is None:
        win = relc[:, None, :] <= torch.arange(
            k1, device=pos.device)[None, :, None]          # (b, q, s)
    else:
        b = pos.shape[0]
        win = torch.gather(anc, 1, relc[:, :, None].expand(
            b, s_len, k1)).transpose(1, 2)                 # (b, q, s)
    return committed[:, None, :] | (in_win[:, None, :] & win)


def _probs(q, kg, vis, softmax_scale):
    """The plain version's fp32 probabilities (b, nh, k1, S): scores
    divided by sqrt(hd) (or times ``softmax_scale``), ``finfo.min``
    where a query cannot see the row, softmax."""
    hd = q.shape[-1]
    scores = torch.matmul(q.float(), kg.transpose(-1, -2))
    scores = scores / math.sqrt(hd) if softmax_scale is None \
        else scores * softmax_scale
    scores = torch.where(vis[:, None], scores,
                         torch.finfo(torch.float32).min)
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
    vis = visible(pos, 1, kg.shape[2])
    probs = _probs(q[:, :, None], kg, vis, softmax_scale)
    return torch.matmul(probs, vg)[:, :, 0].to(q.dtype)


def paged_verify_attention_plain(q, k_pages, v_pages, block_tables, pos,
                                 anc=None, k_scale=None, v_scale=None,
                                 softmax_scale=None) -> torch.Tensor:
    """Plain version: the JAX ``_paged_verify_attention`` (``anc``
    None: the linear mask ``s <= pos + j``) or
    ``_paged_tree_verify_attention`` (``anc`` (b, k1, k1) bool) after
    their writes — gather, upcast (dequantize), fp32 scores masked with
    ``finfo.min`` where a query cannot see the row, fp32 softmax and
    product with V, one cast to q's dtype. q (b, nh, k1, hd)."""
    k1 = _check(q, k_pages, v_pages, block_tables, pos, k_scale, v_scale,
                anc, queries=True)[2]
    kg = _gather(k_pages, k_scale, block_tables)
    vg = _gather(v_pages, v_scale, block_tables)
    vis = visible(pos, k1, kg.shape[2], anc)
    return torch.matmul(_probs(q, kg, vis, softmax_scale), vg).to(q.dtype)


def paged_limit(q, k_pages, v_pages, block_tables, pos, ctx0,
                k_scale=None, v_scale=None, softmax_scale=None,
                anc=None) -> torch.Tensor:
    """How far, per element, the kernel's ctx may sit from the plain
    version's ``ctx0`` on the same inputs: q (b, nh, hd) for one query a
    slot, or (b, nh, k1, hd) for k1 (``anc`` their visibility, None the
    linear mask); the derivation holds per query row. Both take the same
    fp32 inputs (bf16 widens exactly; an int8 row is dequantized by the
    same one multiply) and differ in the order of their sums. With u =
    2^-24, D the largest scaled sum over a query's visible rows of
    |q_e k_e|, A = sum_j p_j |v_j| and n its visible rows of S =
    max_pages * page:

    - a score's rounding, up to 2 hd u D on both sides, and the exps'
      and the normalisation's few u move each p_j by a relative (2 hd D
      + 8) u, and ctx by that times (A + |ctx|);
    - the sums over the rows add at most (n + S + 32) u A (a sequential
      sum's worst case on each side);
    - a bf16 ctx is rounded once on each side: one bf16 ulp more,
      2^-7 |ctx0|."""
    queries = q.dim() == 4
    b, nh, k1, page, hd, mp = _check(q, k_pages, v_pages, block_tables,
                                     pos, k_scale, v_scale, anc, queries)
    q4 = q if queries else q[:, :, None]
    kg = _gather(k_pages, k_scale, block_tables)
    vg = _gather(v_pages, v_scale, block_tables)
    s_len = mp * page
    scale = abs(_scale(hd, softmax_scale))
    vis = visible(pos, k1, s_len, anc)                    # (b, k1, S)
    dots = torch.matmul(q4.float().abs(), kg.abs().transpose(-1, -2)) \
        * scale                                           # (b, nh, k1, S)
    d_max = torch.where(vis[:, None], dots,
                        torch.zeros((), device=q.device)).amax(-1)
    a = torch.matmul(_probs(q4, kg, vis, softmax_scale), vg.abs())
    n = vis.sum(-1).float()[:, None, :, None]             # (b, 1, k1, 1)
    o = (ctx0 if queries else ctx0[:, :, None]).float().abs()
    lim = _U * ((2 * hd * d_max + 8)[..., None] * (a + o)
                + (n + s_len + 32) * a)
    if q.dtype == torch.bfloat16:
        lim = lim + 2.0 ** -7 * o
    return lim if queries else lim[:, :, 0]


def _launch(kernel, q, k_pages, v_pages, block_tables, pos, anc, k_scale,
            v_scale, softmax_scale, queries):
    b, nh, k1, page, hd, mp = _check(q, k_pages, v_pages, block_tables,
                                     pos, k_scale, v_scale, anc, queries)
    ts = [q, k_pages, v_pages, block_tables, pos] + (
        [k_scale, v_scale] if k_scale is not None else []) + (
        [anc] if anc is not None else [])
    name = "paged_verify_attention" if queries else "paged_decode_attention"
    if any(t.device != q.device or t.device.type != "cuda" for t in ts):
        raise RuntimeError(f"{name} kernel needs CUDA tensors on one "
                           "device")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError(f"{name} kernel needs contiguous q, pools, "
                         "scales, block_tables, pos and anc")
    out = torch.empty_like(q)
    kernel(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
           None if k_scale is None else k_scale.data_ptr(),
           None if v_scale is None else v_scale.data_ptr(),
           block_tables.data_ptr(), pos.data_ptr(),
           None if anc is None else anc.data_ptr(), out.data_ptr(),
           b, nh, k1, page, hd, mp, _Q_DTYPES[q.dtype],
           _KV_DTYPES[k_pages.dtype], float(_scale(hd, softmax_scale)),
           torch.cuda.current_stream(q.device).cuda_stream)
    return out


def paged_decode_attention_kernel(q, k_pages, v_pages, block_tables, pos,
                                  k_scale=None, v_scale=None,
                                  softmax_scale=None) -> torch.Tensor:
    """Launch ``csrc/paged_attention.cu`` at one query a slot. Every
    tensor on one CUDA device and contiguous; returns ctx (b, nh, hd) in
    q's dtype."""
    return _launch(PAGED_DECODE, q, k_pages, v_pages, block_tables, pos,
                   None, k_scale, v_scale, softmax_scale, False)


def paged_verify_attention_kernel(q, k_pages, v_pages, block_tables, pos,
                                  anc=None, k_scale=None, v_scale=None,
                                  softmax_scale=None) -> torch.Tensor:
    """Launch ``csrc/paged_attention.cu`` at k1 queries a slot (at most
    :data:`MAX_K1`; the C entry refuses more). Every tensor on one CUDA
    device and contiguous; returns ctx (b, nh, k1, hd) in q's dtype."""
    return _launch(PAGED_VERIFY, q, k_pages, v_pages, block_tables, pos,
                   anc, k_scale, v_scale, softmax_scale, True)


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


def paged_verify_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor,
                           block_tables: torch.Tensor, pos: torch.Tensor,
                           anc: Optional[torch.Tensor] = None,
                           k_scale: Optional[torch.Tensor] = None,
                           v_scale: Optional[torch.Tensor] = None,
                           softmax_scale: Optional[float] = None
                           ) -> torch.Tensor:
    """ctx (b, nh, k1, hd) in q's dtype: the k1 queries q (b, nh, k1, hd)
    of each slot against one layer's pools, as
    :func:`paged_decode_attention`, query j seeing the rows ``s < pos``
    and the window rows ``anc`` (b, k1, k1) bool admits (``s <= pos +
    j`` without it). A CUDA q launches the kernel; a CPU q runs the
    plain version."""
    fn = paged_verify_attention_kernel if on_card(q, "q") \
        else paged_verify_attention_plain
    return fn(q, k_pages, v_pages, block_tables, pos, anc, k_scale,
              v_scale, softmax_scale)

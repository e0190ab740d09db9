"""Attention against a paged KV pool, reading K and V through each
slot's block table: the attention of one decode step (one query a slot),
one speculative verify step (k1 queries a slot) or one slot's prompt
chunk (sc queries) over ``serving.cache.PagedKVCache``, after the step
has written its rows.

The JAX package computes it as plain XLA inside
``apex_tpu/models/gpt.py``: ``_paged_decode_attention`` (:403),
``_paged_verify_attention`` (:537), ``_paged_tree_verify_attention``
(:816), the int8 forms ``_paged_decode_attention_q8`` (:951) and
``_paged_verify_attention_q8`` (:1004), and the chunk's
``_paged_chunk_prefill_attention`` (:659). It gathers each slot's whole
block-table row out of the pool (``k_pages[block_tables]``), upcasts it
to fp32 (dequantizes an int8 pool against its per-page-per-head
scales), takes fp32 scores over the logical positions, sets those a
query cannot see to ``finfo(f32).min`` (probability exactly 0), and
takes the fp32 softmax and the fp32 product with V, cast to q's dtype.
Query j of a slot at length ``pos`` sees row s when ``s < pos``, or when
``0 <= s - pos < k1`` and ``anc[s - pos, j]`` (``_tree_score_mask``,
:739); the linear verify and the chunk are ``s <= pos + j``, the decode
step ``s <= pos``. Three versions of that function:

- the decode and verify kernel (``csrc/paged_attention.cu``,
  ``apx_paged_attention``): each slot's rows ``0 .. pos + k1 - 1`` cut
  into parts of :data:`PART_ROWS` logical positions, one block a (part,
  head, slot) reading its part's rows once for all k1 queries, each
  row's physical page from the table; a part's softmax in fp32 a query
  in an order fixed by logical position, the parts combined in part
  order — the same logical contents under any page placement give the
  same bits, and column j of a linear verify the bits of a decode step
  at ``pos + j``;
- the prompt-chunk kernel (the same file, ``apx_paged_chunk_attention``):
  bf16 q and pool on the tensor cores, one launch a chunk over a (query
  tile, part, head, slot) grid; no bit relation to the decode step (the
  reference promises none, and speculation does not reach it), the same
  bits under any page placement;
- the plain version, the JAX function's gather, upcast, mask, softmax
  and product in its order of operations.

They sum in other orders and are held to each other by
:func:`paged_limit` and :func:`chunk_limit`. Dispatch: a CUDA tensor
launches a kernel (``PAGED_DECODE`` for one query a slot,
``PAGED_VERIFY`` for k1, ``PAGED_CHUNK`` for a chunk that
:func:`chunk_kernel_takes`) or raises; a CPU tensor runs the plain
version.

One verify launch holds at most :data:`MAX_K1` queries a slot
(:func:`verify_slices`). A wider verify window runs as one launch a
slice of its queries, each slice reading the window's rows as a whole
launch would: query j's sums do not depend on the other queries, so the
slices give the bits of one launch over all of them. An fp32 chunk, or
one whose head width the chunk kernel does not take, is such a window.
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
_ARGS = [_P] * 11 + [_I] * 10 + [ctypes.c_float, _P]
# one C entry; the two wrappers count their launches apart
PAGED_DECODE = Kernel(LIB, "apx_paged_attention", _ARGS)
PAGED_VERIFY = Kernel(LIB, "apx_paged_attention", _ARGS)
PAGED_CHUNK = Kernel(LIB, "apx_paged_chunk_attention",
                     [_P] * 8 + [_I] * 7 + [ctypes.c_float, _P])
#: The most queries a slot one launch holds; its C entry refuses more.
MAX_K1 = 64
#: The widest head the decode and verify kernel takes.
MAX_HD = 256
#: The logical positions a part of a slot's rows holds in the decode and
#: verify kernel (csrc/paged_attention.cu's kPart).
PART_ROWS = 128
# csrc/paged_attention.cu's kRowPad and kMaxSmem, for verify_slices
_ROW_PAD, _MAX_SMEM = 16, 232448
_Q_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KV_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_U = 2.0 ** -24      # fp32 unit roundoff
#: The widest head the chunk kernel takes (a multiple of 8).
CHUNK_MAX_HD = 128
# csrc/paged_attention.cu's chunk::kBQ (= kBK), kMinTiles and kMaxSplits
_CBQ, _MIN_TILES, _MAX_SPLITS = 64, 2, 4
# the split kernels' arrival counters and work buffers: per device, every
# buffer ever handed out, the newest last
_COUNTERS = {}
_WORK = {}


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


def _smem(nq: int, hd: int, esz: int) -> int:
    """The C file's ``smem_bytes(nq, hd, esz)``: a part's row offsets
    (8 bytes a row), its K and V rows (``hd * esz`` rounded up to 16
    bytes, plus 16; V in K's buffer when both would not fit beside
    :data:`MAX_K1` queries), a query's q (hd rounded up to 4 floats),
    scores, m and l, the int8 scales (two floats a row) and a 16-byte
    flag."""
    rs = -(-hd * esz // 16) * 16 + _ROW_PAD
    hq = -(-hd // 4) * 4

    def of(n, kv_rows):
        return (8 * PART_ROWS + kv_rows * rs
                + 4 * (n * (hq + PART_ROWS + 2) + 2 * PART_ROWS) + 16)

    kv_rows = 2 * PART_ROWS if of(MAX_K1, 2 * PART_ROWS) <= _MAX_SMEM \
        else PART_ROWS
    return of(nq, kv_rows)


def verify_slices(k1: int, hd: int):
    """``[(q0, nq), ...]``: the window's k1 queries in consecutive
    slices of as many as one launch holds: :data:`MAX_K1`, fewer where
    their shared memory at ``hd`` would pass the card's for some pool
    type (the C file's ``smem_bytes``; 62 at hd 256 over an fp32
    pool)."""
    if hd > MAX_HD:
        raise ValueError(f"head_dim {hd}: the paged attention kernel takes "
                         f"head_dim up to {MAX_HD}")
    step = max(n for n in range(1, MAX_K1 + 1)
               if all(_smem(n, hd, esz) <= _MAX_SMEM for esz in (1, 2, 4)))
    return [(q0, min(step, k1 - q0)) for q0 in range(0, k1, step)]


def paged_parts(s_len: int) -> int:
    """The parts of :data:`PART_ROWS` logical positions the decode and
    verify kernel's grid holds a (head, slot) for a table of ``s_len``
    rows (the grid is sized before ``pos`` is known; on the card a
    launch's parts past the last row its queries may see exit at once)."""
    return -(-s_len // PART_ROWS)


def paged_work_floats(b: int, nh: int, nq: int, hd: int, s_len: int) -> int:
    """The fp32 work buffer one launch of the decode and verify kernel
    takes: a (slot, head, part, query)'s accumulator (hd rounded up to 4
    floats) and its m and l; 0 when every slot's rows fit one part (the
    kernel writes ctx directly)."""
    parts = paged_parts(s_len)
    if parts == 1:
        return 0
    return b * nh * parts * nq * (-(-hd // 4) * 4 + 2)


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
            anc: Optional[torch.Tensor] = None, q0: int = 0,
            nq: Optional[int] = None) -> torch.Tensor:
    """(b, nq, s_len) bool: key row s visible to query q0 + j of slot b
    (all k1 queries by default) — the JAX ``_tree_score_mask``: ``s <
    pos``, or ``0 <= s - pos < k1`` and ``anc[b, s - pos, q0 + j]``
    (``s - pos <= q0 + j`` without ``anc``)."""
    nq = k1 - q0 if nq is None else nq
    s_idx = torch.arange(s_len, device=pos.device)
    rel = s_idx[None, :] - pos.long()[:, None]            # (b, s)
    committed = rel < 0
    in_win = (rel >= 0) & (rel < k1)
    relc = rel.clamp(0, k1 - 1)
    if anc is None:
        win = relc[:, None, :] <= torch.arange(
            q0, q0 + nq, device=pos.device)[None, :, None]  # (b, q, s)
    else:
        b = pos.shape[0]
        win = torch.gather(anc[:, :, q0:q0 + nq], 1, relc[:, :, None].expand(
            b, s_len, nq)).transpose(1, 2)                 # (b, q, s)
    return committed[:, None, :] | (in_win[:, None, :] & win)


def _probs(q, kg, vis, softmax_scale):
    """The plain version's fp32 probabilities (b, nh, k1, S): scores
    times 1/sqrt(hd) (or ``softmax_scale``; the prefill's scale, so an
    fp32 chunk's rows are a one-shot prefill's), ``finfo.min`` where a
    query cannot see the row, softmax."""
    scores = torch.matmul(q.float(), kg.transpose(-1, -2)) \
        * _scale(q.shape[-1], softmax_scale)
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
                                 softmax_scale=None, q0: int = 0,
                                 nq: Optional[int] = None) -> torch.Tensor:
    """Plain version: the JAX ``_paged_verify_attention`` (``anc``
    None: the linear mask ``s <= pos + j``) or
    ``_paged_tree_verify_attention`` (``anc`` (b, k1, k1) bool) after
    their writes — gather, upcast (dequantize), fp32 scores masked with
    ``finfo.min`` where a query cannot see the row, fp32 softmax and
    product with V, one cast to q's dtype. q (b, nh, k1, hd); returns
    the ctx of the window's queries ``q0 .. q0 + nq - 1`` (all k1 by
    default), as one kernel launch of that slice computes them."""
    k1 = _check(q, k_pages, v_pages, block_tables, pos, k_scale, v_scale,
                anc, queries=True)[2]
    nq = k1 - q0 if nq is None else nq
    kg = _gather(k_pages, k_scale, block_tables)
    vg = _gather(v_pages, v_scale, block_tables)
    vis = visible(pos, k1, kg.shape[2], anc, q0, nq)
    return torch.matmul(_probs(q[:, :, q0:q0 + nq], kg, vis, softmax_scale),
                        vg).to(q.dtype)


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
    - the kernel cuts the rows into parts of :data:`PART_ROWS`, at most
      N = :func:`paged_parts` (S) of them, each with its own max m_p,
      and weighs part p by w_p = exp(m_p - M), M the largest m_p: the
      subtraction's rounding (u |m_p - M| <= 2 u D), the exp's 2 ulp
      (4 u), one rounding of each product w_p l_p and w_p acc_p, and
      the sums over the parts one rounding a part, N - 1: each term of
      acc and of l moves by a relative (2 D + N + 4) u, and ctx by that
      times (A + |ctx|);
    - a bf16 ctx is rounded once on each side: one bf16 ulp more,
      2^-7 |ctx0|."""
    queries = q.dim() == 4
    d_max, a, n, o, s_len, hd = _limit_terms(
        q if queries else q[:, :, None], k_pages, v_pages, block_tables,
        pos, ctx0 if queries else ctx0[:, :, None], k_scale, v_scale,
        softmax_scale, anc)
    lim = (_paged_terms(q, d_max, a, n, o, s_len, hd)
           + _U * (2 * d_max + paged_parts(s_len) + 4) * (a + o))
    return lim if queries else lim[:, :, 0]


def _limit_terms(q4, k_pages, v_pages, block_tables, pos, ctx0, k_scale,
                 v_scale, softmax_scale, anc):
    """The quantities of the error models, per query row of q4 (b, nh,
    k1, hd): D (b, nh, k1, 1), A and |ctx0| (b, nh, k1, hd), n (b, 1, k1,
    1), S and hd."""
    b, nh, k1, page, hd, mp = _check(q4, k_pages, v_pages, block_tables,
                                     pos, k_scale, v_scale, anc, True)
    kg = _gather(k_pages, k_scale, block_tables)
    vg = _gather(v_pages, v_scale, block_tables)
    s_len = mp * page
    scale = abs(_scale(hd, softmax_scale))
    vis = visible(pos, k1, s_len, anc)                    # (b, k1, S)
    dots = torch.matmul(q4.float().abs(), kg.abs().transpose(-1, -2)) \
        * scale                                           # (b, nh, k1, S)
    d_max = torch.where(vis[:, None], dots,
                        torch.zeros((), device=q4.device)).amax(-1)
    a = torch.matmul(_probs(q4, kg, vis, softmax_scale), vg.abs())
    n = vis.sum(-1).float()[:, None, :, None]             # (b, 1, k1, 1)
    return d_max[..., None], a, n, ctx0.float().abs(), s_len, hd


def _paged_terms(q, d_max, a, n, o, s_len, hd):
    lim = _U * ((2 * hd * d_max + 8) * (a + o) + (n + s_len + 32) * a)
    if q.dtype == torch.bfloat16:
        lim = lim + 2.0 ** -7 * o
    return lim


def chunk_limit(q, k_pages, v_pages, gather_row, pos, ctx0,
                softmax_scale=None) -> torch.Tensor:
    """How far, per element, the chunk kernel's ctx may sit from the
    plain version's ``ctx0`` on the same inputs (q (b, nh, sc, hd), the
    linear mask): :func:`paged_limit`'s terms, and what the tensor-core
    path changes. With u = 2^-24, D, A and S as there, and Dm = hd
    rounded up to 32, 64 or 128 (the kernel's zero-padded tile):

    - a step of ``mma.sync`` adds 16 exact bf16 products to its fp32
      accumulator, aligned to the largest and each truncated at 2^-23 of
      it (the model of NVIDIA's tensor cores in Fasi et al., 2021): at
      most 17 x 2u of the step's sum of |terms| with the accumulator's.
      A score takes Dm / 16 steps, 34 Dm / 16 u D, which moves each p_j
      relatively and ctx by that times (A + |ctx|);
    - the exps (``expf``, 2 ulp), the rescales of acc and l on each of
      up to S / 64 + 1 tiles (one rounding each), the combine of a
      block's two key halves and of a split walk's parts (weights
      exp(m_p - M), their products and sums over up to 4 parts): (2 (S
      / 64 + 1) + 24) u (A + |ctx|);
    - P V: each output's accumulator takes two steps (hi, lo) a 16-row
      group of every tile read, up to S + 64 rows: (S + 64) / 8 steps of
      34 u A;
    - p is multiplied as hi + lo, its residual below 2^-16 p: 2^-16 A.

    A product the tensor core flushes as subnormal (p below 2^-126) is
    below every term here."""
    d_max, a, n, o, s_len, hd = _limit_terms(
        q, k_pages, v_pages, gather_row, pos, ctx0, None, None,
        softmax_scale, None)
    dm = 32 if hd <= 32 else 64 if hd <= 64 else 128
    mma = 34 * _U
    return (_paged_terms(q, d_max, a, n, o, s_len, hd)
            + (mma * dm / 16 * d_max
               + _U * (2 * (s_len / 64 + 1) + 24)) * (a + o)
            + (mma * (s_len + 64) / 8 + 2.0 ** -16) * a)


def _cached(store, n: int, dev, make) -> torch.Tensor:
    """The newest buffer of ``store`` on ``dev`` if it holds ``n``
    elements, else a new one of ``make(size)`` (at least twice the old).
    Older buffers stay referenced: a CUDA graph captured against one
    keeps valid pointers."""
    key = dev.index if dev.index is not None else torch.cuda.current_device()
    bufs = store.setdefault(key, [])
    if not bufs or bufs[-1].numel() < n:
        old = bufs[-1].numel() if bufs else 0
        bufs.append(make(max(n, 2 * old, 1024)))
    return bufs[-1]


def _counters(units: int, dev) -> torch.Tensor:
    """The split kernels' arrival counters (the decode and verify
    kernel's and the chunk kernel's): a zeroed int32 buffer kept per
    device and grown as needed. Each launch finds its counters zero and
    leaves them zero (the last part of a unit resets its own), so one
    buffer serves every launch on the device, CUDA-graph replays
    included; split launches must not run on two streams of one device
    at once."""
    return _cached(_COUNTERS, units, dev, lambda n: torch.zeros(
        (n,), dtype=torch.int32, device=dev))


def _work(floats: int, dev) -> torch.Tensor:
    """The split kernels' fp32 work buffer (the parts' records), kept per
    device beside :func:`_counters` and grown as needed. A launch reads
    only records it wrote itself, after its arrival count, so launches
    in one stream share it; as for the counters, split launches must not
    run on two streams of one device at once."""
    return _cached(_WORK, floats, dev, lambda n: torch.empty(
        (n,), dtype=torch.float32, device=dev))


def _launch(kernel, q, k_pages, v_pages, block_tables, pos, anc, k_scale,
            v_scale, softmax_scale, queries, q0=0, nq=None, out=None):
    b, nh, k1, page, hd, mp = _check(q, k_pages, v_pages, block_tables,
                                     pos, k_scale, v_scale, anc, queries)
    nq = k1 - q0 if nq is None else nq
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
    if out is None:
        out = torch.empty_like(q)
    elif out.shape != q.shape or out.dtype != q.dtype \
            or out.device != q.device or not out.is_contiguous():
        raise ValueError(f"out must be a contiguous tensor like q "
                         f"{tuple(q.shape)} {_name(q.dtype)}")
    work = counters = None
    floats = paged_work_floats(b, nh, nq, hd, mp * page)
    if floats:
        work = _work(floats, q.device)
        counters = _counters(b * nh, q.device)
    kernel(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
           None if k_scale is None else k_scale.data_ptr(),
           None if v_scale is None else v_scale.data_ptr(),
           block_tables.data_ptr(), pos.data_ptr(),
           None if anc is None else anc.data_ptr(), out.data_ptr(),
           None if work is None else work.data_ptr(),
           None if counters is None else counters.data_ptr(),
           b, nh, k1, q0, nq, page, hd, mp, _Q_DTYPES[q.dtype],
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
                                  softmax_scale=None, q0: int = 0,
                                  nq: Optional[int] = None,
                                  out: Optional[torch.Tensor] = None
                                  ) -> torch.Tensor:
    """One launch of ``csrc/paged_attention.cu`` over the window's
    queries ``q0 .. q0 + nq - 1`` of q's k1 (all by default; at most
    :data:`MAX_K1` and the shared memory :func:`verify_slices` allows,
    or the C entry refuses). Every tensor on one CUDA device and
    contiguous; writes those queries' ctx into ``out`` (b, nh, k1, hd)
    in q's dtype, a new tensor by default, and returns it."""
    return _launch(PAGED_VERIFY, q, k_pages, v_pages, block_tables, pos,
                   anc, k_scale, v_scale, softmax_scale, True, q0, nq, out)


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
    j`` without it). Any k1: a CUDA q launches the kernel once a slice
    of :func:`verify_slices` (once up to :data:`MAX_K1` queries at hd
    64); a CPU q runs the plain version."""
    if not on_card(q, "q"):
        return paged_verify_attention_plain(
            q, k_pages, v_pages, block_tables, pos, anc, k_scale, v_scale,
            softmax_scale)
    out = torch.empty_like(q)
    for q0, nq in verify_slices(q.shape[2], q.shape[-1]):
        paged_verify_attention_kernel(q, k_pages, v_pages, block_tables,
                                      pos, anc, k_scale, v_scale,
                                      softmax_scale, q0, nq, out)
    return out


def chunk_kernel_takes(q: torch.Tensor, k_pages: torch.Tensor) -> bool:
    """The chunk's dispatch rule on the card, from dtypes and shapes
    alone: bf16 q and a bf16 pool, head width a multiple of 8 up to
    :data:`CHUNK_MAX_HD`, go to the chunk kernel; anything else (an fp32
    q or pool, another width) to :func:`paged_verify_attention` as a
    linear verify window of k1 = sc."""
    hd = q.shape[-1]
    return (q.dtype == torch.bfloat16 and k_pages.dtype == torch.bfloat16
            and hd % 8 == 0 and hd <= CHUNK_MAX_HD)


def chunk_splits(s_len: int) -> int:
    """The most parts the chunk kernel cuts a 64-query tile's walk over
    the rows into, from the table's ``s_len`` rows (the grid is sized
    before ``pos`` is known): one part for every 2 64-row tiles, at most
    4 (the C file's kMinTiles and kMaxSplits). On the card a query tile
    takes ``min(splits, tiles // 2)`` parts, at least one, of the tiles
    its queries see."""
    return max(1, min(_MAX_SPLITS, -(-s_len // _CBQ) // _MIN_TILES))


def paged_chunk_attention_plain(q, k_pages, v_pages, gather_row, pos,
                                softmax_scale=None) -> torch.Tensor:
    """Plain version: the JAX ``_paged_chunk_prefill_attention`` after
    its write — :func:`paged_verify_attention_plain` over the linear
    mask ``s <= pos + j``: gather through ``gather_row``, upcast, fp32
    scores masked with ``finfo.min``, fp32 softmax and product with V,
    one cast to q's dtype."""
    return paged_verify_attention_plain(q, k_pages, v_pages, gather_row,
                                        pos, None,
                                        softmax_scale=softmax_scale)


def paged_chunk_attention_kernel(q, k_pages, v_pages, gather_row, pos,
                                 softmax_scale=None,
                                 splits: Optional[int] = None
                                 ) -> torch.Tensor:
    """One launch of ``csrc/paged_attention.cu``'s chunk kernel: q (b,
    nh, sc, hd) bf16 against bf16 pools through ``gather_row`` (b,
    max_pages) int32 at ``pos`` (b,) int32, the linear mask. ``splits``
    (1 to 4) caps the parts of a tile's walk, :func:`chunk_splits` of
    the table by default. Every tensor on one CUDA device and
    contiguous; returns ctx (b, nh, sc, hd) bf16."""
    b, nh, sc, page, hd, mp = _check(q, k_pages, v_pages, gather_row, pos,
                                     None, None, queries=True)
    name = "paged_chunk_attention"
    if not chunk_kernel_takes(q, k_pages):
        raise ValueError(f"{name} kernel takes bf16 q and pools with "
                         f"head_dim a multiple of 8 up to {CHUNK_MAX_HD}, "
                         f"got {_name(q.dtype)}/{_name(k_pages.dtype)}, "
                         f"hd {hd}")
    ts = (q, k_pages, v_pages, gather_row, pos)
    if any(t.device != q.device or t.device.type != "cuda" for t in ts):
        raise RuntimeError(f"{name} kernel needs CUDA tensors on one "
                           "device")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError(f"{name} kernel needs contiguous q, pools, "
                         "gather_row and pos")
    splits = chunk_splits(mp * page) if splits is None else splits
    units = b * nh * -(-sc // _CBQ)
    work = counters = None
    if splits > 1:
        work = _work(splits * units * _CBQ * (hd + 2), q.device)
        counters = _counters(units, q.device)
    out = torch.empty_like(q)
    PAGED_CHUNK(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                gather_row.data_ptr(), pos.data_ptr(), out.data_ptr(),
                None if work is None else work.data_ptr(),
                None if counters is None else counters.data_ptr(),
                b, nh, sc, page, hd, mp, splits,
                float(_scale(hd, softmax_scale)),
                torch.cuda.current_stream(q.device).cuda_stream)
    return out


def paged_chunk_attention(q: torch.Tensor, k_pages: torch.Tensor,
                          v_pages: torch.Tensor, gather_row: torch.Tensor,
                          pos: torch.Tensor,
                          softmax_scale: Optional[float] = None
                          ) -> torch.Tensor:
    """ctx (b, nh, sc, hd) in q's dtype: a prompt chunk's queries q (b,
    nh, sc, hd), query j at logical position ``pos + j``, against one
    layer's fp32 or bf16 pools through ``gather_row`` (b, max_pages)
    int32, seeing the rows ``s <= pos + j``. An int8 pool is refused, as
    the JAX package refuses chunked prefill over it. A CPU q runs the
    plain version. A CUDA q launches the chunk kernel once where
    :func:`chunk_kernel_takes` (bf16 q and pool, hd a multiple of 8 up
    to 128), else goes through :func:`paged_verify_attention` (one
    launch a slice of ``verify_slices(sc, hd)``)."""
    if k_pages.dtype == torch.int8:
        raise ValueError("chunked prefill is not offered over the int8 "
                         "page pool (kv8 keeps monolithic prefill)")
    if not on_card(q, "q"):
        return paged_chunk_attention_plain(q, k_pages, v_pages, gather_row,
                                           pos, softmax_scale)
    if chunk_kernel_takes(q, k_pages):
        return paged_chunk_attention_kernel(q, k_pages, v_pages, gather_row,
                                            pos, softmax_scale)
    return paged_verify_attention(q, k_pages, v_pages, gather_row, pos, None,
                                  softmax_scale=softmax_scale)

"""Flat-buffer kernels (counterpart of
``apex_tpu/multi_tensor_apply/kernels.py``): ``flat_adam`` (the Pallas
``_adam_kernel``), the one the BERT step's ``FusedAdam(use_flat_kernel=
True)`` runs; ``flat_lamb`` (``_l2_kernel`` for the global grad-norm
pre-pass and ``_lamb_stage1_kernel``, then stage 2 in PyTorch), the one
``FusedLAMB(use_flat_kernel=True)`` runs; ``flat_scale`` and
``flat_axpby`` (``_scale_kernel``, ``_axpby_kernel``); ``flat_sgd``,
``flat_adagrad`` and ``flat_novograd`` (``_sgd_kernel``,
``_adagrad_kernel``, and ``_l2_kernel`` then ``_novograd_kernel``), the
ones ``FusedSGD``, ``FusedAdagrad`` and ``FusedNovoGrad`` run with
``use_flat_kernel=True``.

Hyperparameters are one fp32 vector on the device (the JAX kernel's SMEM
vector), with the bias corrections ``c1 = 1 - beta1^t`` and ``c2 = 1 -
beta2^t`` computed there from the step, LAMB's ``1 / clip`` there from
the grad-norm pre-pass, SGD's first-run flag from the step count and
NovoGrad's per-tensor second moment from the L2 pre-pass, so a step never
waits on the host. ``found_inf`` (a 0-d bool on the device, apex's
``noop_flag``) makes the step write the old values.

Adam's and LAMB's outputs are new tensors: the inputs, the caller's
optimizer state among them, stay as they were. SGD, Adagrad and NovoGrad
update params and state in place and return those same tensors, as the
JAX kernels alias them (``input_output_aliases``).

Dispatch: a CUDA tensor launches the hand-written kernel
(``csrc/multi_tensor.cu``) or raises; a CPU tensor takes the plain
PyTorch version beside it. The elementwise plain versions repeat their
kernel's arithmetic operation for operation, so on the card the two
agree bit for bit; a sum of squares is taken in another order by each,
and is held to the error models below (``sum_sq_limit``,
``lamb_p_limit``).
"""

import ctypes
from typing import Optional, Tuple, Union

import torch

from apex_tpu_torch.multi_tensor_apply.flatten import ALIGN_ROWS, LANES
from apex_tpu_torch.utils.cuda_build import CudaLibrary, Kernel
from apex_tpu_torch.utils.math import cdiv
from apex_tpu_torch.utils.platform import on_card

LIB = CudaLibrary("multi_tensor")
_P = ctypes.c_void_p
_N = ctypes.c_longlong
_I = ctypes.c_int
FLAT_ADAM = Kernel(LIB, "apx_flat_adam", [_P] * 10 + [_N, _I, _P])
FLAT_SCALE = Kernel(LIB, "apx_flat_scale", [_P] * 4 + [_N, _I, _I, _P])
FLAT_AXPBY = Kernel(LIB, "apx_flat_axpby", [_P] * 5 + [_N, _I, _I, _I, _P])
FLAT_L2NORM = Kernel(LIB, "apx_flat_l2norm_partials", [_P, _P, _N, _N, _P])
FLAT_LAMB_STAGE1 = Kernel(LIB, "apx_flat_lamb_stage1",
                          [_P] * 11 + [_N, _I, _P])
FLAT_SGD = Kernel(LIB, "apx_flat_sgd", [_P] * 6 + [_N, _I, _P])
FLAT_ADAGRAD = Kernel(LIB, "apx_flat_adagrad", [_P] * 6 + [_N, _P])
FLAT_NOVOGRAD = Kernel(LIB, "apx_flat_novograd", [_P] * 7 + [_N, _I, _P])
_M_DTYPES = (torch.float32, torch.bfloat16)
_IO_DTYPES = (torch.float32, torch.bfloat16)   # flat_scale, flat_axpby
SUB = 8 * LANES     # elements in one (8, 128) sub-tile: one partial each
U = 2.0 ** -24      # fp32 unit roundoff

Scalar = Union[float, int, torch.Tensor]


def _f32(x: Scalar, device) -> torch.Tensor:
    """A 0-d fp32 tensor on ``device``, made there (no host copy)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.full((), float(x), dtype=torch.float32, device=device)


def adam_hparams(*, lr: Scalar, beta1: float, beta2: float, eps: float,
                 step: Scalar, weight_decay: Scalar, adam_w_mode: bool,
                 bias_correction: bool, grad_scale: Scalar,
                 device) -> torch.Tensor:
    """The (9,) fp32 hyperparameter vector, on ``device``, in the JAX
    kernel's order; c1 and c2 in fp32 from the step as the JAX
    ``flat_adam`` computes them (1.0 without bias correction)."""
    b1, b2 = _f32(beta1, device), _f32(beta2, device)
    if bias_correction:
        t = _f32(step, device)
        c1, c2 = 1.0 - b1 ** t, 1.0 - b2 ** t
    else:
        c1 = c2 = _f32(1.0, device)
    return torch.stack([
        _f32(lr, device), b1, b2, _f32(eps, device),
        _f32(weight_decay, device), c1, c2,
        _f32(1.0 if adam_w_mode else 0.0, device), _f32(grad_scale, device)])


def flat_adam_plain(grads, params, m, v, hp, found_inf=None,
                    emit_compute_dtype=None) -> Tuple[torch.Tensor, ...]:
    """Plain version of the kernel: ``(p, m, v[, compute])``, the same
    fp32 operations in the same order."""
    lr, b1, b2, eps, wd, c1, c2, aw, gs = hp.unbind()
    p = params
    g = grads.float() * gs
    gl = g + ((1.0 - aw) * wd) * p
    m32 = b1 * m.float() + (1.0 - b1) * gl
    v_new = b2 * v + ((1.0 - b2) * gl) * gl
    u = (m32 / c1) / (torch.sqrt(v_new / c2) + eps) + (aw * wd) * p
    p_new = p - lr * u
    m_new = m32.to(m.dtype)
    if found_inf is not None:
        p_new = torch.where(found_inf, p, p_new)
        m_new = torch.where(found_inf, m, m_new)
        v_new = torch.where(found_inf, v, v_new)
    outs = (p_new, m_new, v_new)
    if emit_compute_dtype is not None:
        outs += (p_new.to(emit_compute_dtype),)
    return outs


def _check(who: str, name: str, t: torch.Tensor, like: torch.Tensor,
           dtypes=(torch.float32,)) -> None:
    if t.device != like.device or t.shape != like.shape \
            or t.dtype not in dtypes or not t.is_contiguous() \
            or t.data_ptr() % 16:
        raise RuntimeError(
            f"{who} kernel needs a contiguous, 16-byte aligned "
            f"{tuple(like.shape)} {name} of {[str(d) for d in dtypes]} on "
            f"{like.device}, got {tuple(t.shape)} {t.dtype} on {t.device}")


def _check_buffer(who: str, t: torch.Tensor, dtypes=(torch.float32,),
                  multiple: int = 4) -> None:
    """The first buffer of a launch: on CUDA, in ``dtypes``, contiguous,
    16-byte aligned, ``multiple`` elements at a time."""
    if t.device.type != "cuda":
        raise RuntimeError(f"{who} kernel needs CUDA tensors, got a "
                           f"buffer on {t.device}")
    _check(who, "buffer", t, t, dtypes)
    if t.numel() % multiple:
        raise RuntimeError(f"{who} kernel needs a multiple of {multiple} "
                           f"elements, got {t.numel()}")


def _check_device_vector(who: str, hp: torch.Tensor, n: int,
                         like: torch.Tensor) -> None:
    if hp.shape != (n,) or hp.dtype != torch.float32 \
            or hp.device != like.device or not hp.is_contiguous():
        raise RuntimeError(f"{who} kernel needs its ({n},) fp32 "
                           f"hyperparameters on {like.device}")


def _check_found(who: str, found_inf: Optional[torch.Tensor],
                 like: torch.Tensor) -> None:
    if found_inf is not None and (found_inf.shape != () or found_inf.dtype
                                  != torch.bool or found_inf.device
                                  != like.device):
        raise RuntimeError(f"{who} kernel needs found_inf as a 0-d bool "
                           f"on {like.device}")


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def flat_adam_kernel(grads, params, m, v, hp, found_inf=None,
                     emit_compute_dtype=None) -> Tuple[torch.Tensor, ...]:
    """Launch ``csrc/multi_tensor.cu`` on CUDA tensors: ``(p, m, v[,
    compute])`` as new tensors. Raises on anything the kernel does not
    take (fp32 grads, params and v; fp32 or bf16 m; a bf16 cast-out)."""
    who = "flat_adam"
    _check_buffer(who, params)
    _check(who, "grads", grads, params)
    _check(who, "m", m, params, _M_DTYPES)
    _check(who, "v", v, params)
    _check_device_vector(who, hp, 9, params)
    _check_found(who, found_inf, params)
    if emit_compute_dtype not in (None, torch.bfloat16):
        raise RuntimeError(f"flat_adam kernel casts out to bf16 only, not "
                           f"{emit_compute_dtype}")
    p_new, m_new, v_new = (torch.empty_like(t) for t in (params, m, v))
    pc = None if emit_compute_dtype is None else \
        torch.empty_like(params, dtype=torch.bfloat16)
    FLAT_ADAM(grads.data_ptr(), params.data_ptr(), m.data_ptr(), v.data_ptr(),
              p_new.data_ptr(), m_new.data_ptr(), v_new.data_ptr(),
              _ptr(pc), hp.data_ptr(), _ptr(found_inf), params.numel(),
              int(m.dtype == torch.bfloat16), _stream(params))
    outs = (p_new, m_new, v_new)
    return outs if pc is None else outs + (pc,)


def flat_adam(grads: torch.Tensor, params: torch.Tensor, m: torch.Tensor,
              v: torch.Tensor, *, lr: Scalar, beta1: float, beta2: float,
              eps: float, step: Scalar, weight_decay: Scalar,
              adam_w_mode: bool = True, bias_correction: bool = True,
              grad_scale: Scalar = 1.0,
              emit_compute_dtype: Optional[torch.dtype] = None,
              found_inf: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, ...]:
    """One fused Adam/AdamW step over flat buffers: returns ``(p, m,
    v)``, or ``(p, m, v, compute)`` with ``emit_compute_dtype`` (the
    updated params cast to it, written from registers). ``m`` may be
    bf16 (fp32 accumulate, stored round-to-nearest-even); ``v`` stays
    fp32. ``found_inf`` True writes the old values (the step is
    skipped)."""
    hp = adam_hparams(lr=lr, beta1=beta1, beta2=beta2, eps=eps, step=step,
                      weight_decay=weight_decay, adam_w_mode=adam_w_mode,
                      bias_correction=bias_correction, grad_scale=grad_scale,
                      device=params.device)
    fn = flat_adam_kernel if on_card(params, "params") else flat_adam_plain
    return fn(grads, params, m, v, hp, found_inf, emit_compute_dtype)


# ---------------------------------------------------------------------------
# scale and axpby (rows 13 and 14 of the port's kernel table)
# ---------------------------------------------------------------------------

def _io_dtype(who: str, dt: torch.dtype) -> torch.dtype:
    if dt not in _IO_DTYPES:
        raise RuntimeError(f"{who} takes and gives fp32 or bf16, not {dt}")
    return dt


def flat_scale_plain(x: torch.Tensor, s: torch.Tensor,
                     out_dtype: torch.dtype
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: ``(cast(x * s), found_inf)``, the flag on x."""
    xf = x.float()
    return (xf * s).to(out_dtype), torch.logical_not(
        torch.isfinite(xf).all())


def flat_scale_kernel(x: torch.Tensor, s: torch.Tensor,
                      out_dtype: torch.dtype
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``apx_flat_scale`` on a CUDA buffer; ``s`` a 0-d fp32 on
    its device."""
    who = "flat_scale"
    _check_buffer(who, x, _IO_DTYPES)
    _check_device_vector(who, s.reshape(1), 1, x)
    out = torch.empty_like(x, dtype=_io_dtype(who, out_dtype))
    found = torch.zeros((), dtype=torch.bool, device=x.device)
    FLAT_SCALE(x.data_ptr(), out.data_ptr(), s.data_ptr(), found.data_ptr(),
               x.numel(), int(x.dtype == torch.bfloat16),
               int(out_dtype == torch.bfloat16), _stream(x))
    return out, found


def flat_scale(buf: torch.Tensor, scale: Scalar,
               out_dtype: Optional[torch.dtype] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(buf * scale, found_inf)``: the product in fp32, cast to
    ``out_dtype`` (default the buffer's); ``found_inf`` a 0-d bool on the
    device, judged on the incoming values (pre-unscale), as the
    reference's ``overflow_buf``. fp32 and bf16 in and out."""
    out_dtype = _io_dtype("flat_scale", out_dtype or buf.dtype)
    _io_dtype("flat_scale", buf.dtype)
    s = _f32(scale, buf.device)
    fn = flat_scale_kernel if on_card(buf, "buf") else flat_scale_plain
    return fn(buf, s, out_dtype)


def flat_axpby_plain(x: torch.Tensor, y: torch.Tensor, ab: torch.Tensor,
                     out_dtype: torch.dtype
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: ``(cast(a * x + b * y), found_inf)``, each product
    rounded, then the sum; the flag on the fp32 result."""
    a, b = ab.unbind()
    r = a * x.float() + b * y.float()
    return r.to(out_dtype), torch.logical_not(torch.isfinite(r).all())


def flat_axpby_kernel(x: torch.Tensor, y: torch.Tensor, ab: torch.Tensor,
                      out_dtype: torch.dtype
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``apx_flat_axpby`` on CUDA buffers; ``ab`` = (a, b) fp32 on
    their device."""
    who = "flat_axpby"
    _check_buffer(who, x, _IO_DTYPES)
    _check(who, "y", y, x, _IO_DTYPES)
    _check_device_vector(who, ab, 2, x)
    out = torch.empty_like(x, dtype=_io_dtype(who, out_dtype))
    found = torch.zeros((), dtype=torch.bool, device=x.device)
    FLAT_AXPBY(x.data_ptr(), y.data_ptr(), out.data_ptr(), ab.data_ptr(),
               found.data_ptr(), x.numel(), int(x.dtype == torch.bfloat16),
               int(y.dtype == torch.bfloat16),
               int(out_dtype == torch.bfloat16), _stream(x))
    return out, found


def flat_axpby(a: Scalar, x: torch.Tensor, b: Scalar, y: torch.Tensor,
               out_dtype: Optional[torch.dtype] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(a * x + b * y, found_inf)`` over two flat buffers of one shape,
    in fp32, cast to ``out_dtype`` (default x's); ``found_inf`` judged on
    the result. fp32 and bf16 in and out."""
    out_dtype = _io_dtype("flat_axpby", out_dtype or x.dtype)
    for t in (x, y):
        _io_dtype("flat_axpby", t.dtype)
    if x.shape != y.shape:
        raise ValueError(f"flat_axpby needs buffers of one shape, got "
                         f"{tuple(x.shape)} and {tuple(y.shape)}")
    ab = torch.stack([_f32(a, x.device), _f32(b, x.device)])
    fn = flat_axpby_kernel if on_card(x, "x") else flat_axpby_plain
    return fn(x, y, ab, out_dtype)


# ---------------------------------------------------------------------------
# L2 partials (row 15) and LAMB (row 18)
# ---------------------------------------------------------------------------

def sum_sq_limit(ssq: torch.Tensor, n_terms) -> torch.Tensor:
    """Error model of a sum of squares: the limit on |a - b| for two fp32
    sums of the same ``n_terms`` squares taken in any two orders (the
    kernels' lane-then-butterfly order, PyTorch's or XLA's reduction).
    Each side is within (n_terms - 1) u of the exact sum for its
    additions plus u for each square's rounding (nonnegative terms, first
    order), so 2 (n_terms + 1) u ssq covers both with one u to spare;
    ``ssq`` is either side's sum (they agree far inside the spare u)."""
    return 2.0 * (n_terms + 1) * U * ssq.abs()


def _partials_count(buf: torch.Tensor) -> int:
    """JAX's length of the partials: whole (ALIGN_ROWS, 128) blocks."""
    if buf.dim() != 2 or buf.shape[1] != LANES:
        raise ValueError(f"flat_l2norm_partials needs a (rows, {LANES}) "
                         f"buffer, got {tuple(buf.shape)}")
    return cdiv(buf.shape[0], ALIGN_ROWS) * (ALIGN_ROWS * LANES // SUB)


def flat_l2norm_partials_plain(buf: torch.Tensor) -> torch.Tensor:
    """Plain version: the squares in fp32, summed over each sub-tile."""
    n_sub = _partials_count(buf)
    x = buf.reshape(-1).float()
    x = torch.cat([x, x.new_zeros(n_sub * SUB - x.numel())])
    return (x * x).view(n_sub, SUB).sum(1)


def flat_l2norm_partials_kernel(buf: torch.Tensor) -> torch.Tensor:
    """Launch ``apx_flat_l2norm_partials`` on a CUDA fp32 buffer."""
    _check_buffer("flat_l2norm_partials", buf)
    n_sub = _partials_count(buf)
    parts = torch.empty((n_sub,), dtype=torch.float32, device=buf.device)
    FLAT_L2NORM(buf.data_ptr(), parts.data_ptr(), buf.numel(), n_sub,
                _stream(buf))
    return parts


def flat_l2norm_partials(buf: torch.Tensor) -> torch.Tensor:
    """Per-(8, 128)-sub-tile sums of squares, fp32, one for each 1,024
    elements of a ``(rows, 128)`` buffer, padded up to whole (256, 128)
    blocks with zero partials (JAX's length). ``sqrt(sum(partials))`` is
    the global norm; per-tensor sums of them give per-tensor norms."""
    fn = flat_l2norm_partials_kernel if on_card(buf, "buf") else \
        flat_l2norm_partials_plain
    return fn(buf)


def flat_l2norm(buf: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(flat_l2norm_partials(buf).sum())


def lamb_hparams(*, beta1: float, beta2: float, eps: float, step: Scalar,
                 weight_decay: Scalar, adam_w_mode: bool,
                 gs_over_clip: torch.Tensor, device,
                 bias_correction: bool = True,
                 grad_averaging: bool = True) -> torch.Tensor:
    """The (9,) fp32 vector of LAMB's stage 1, on ``device``, in the JAX
    kernel's order: ``b1, b2, eps, wd, c1, c2, adam_w, beta3, grad_scale
    / clip``. c1 and c2 in fp32 from the step (1.0 without bias
    correction); ``beta3 = 1 - beta1`` with grad averaging, taken in
    float64 and rounded, as the JAX flat path takes it (its tree path
    subtracts in fp32), else 1.0."""
    b1, b2 = _f32(beta1, device), _f32(beta2, device)
    if bias_correction:
        t = _f32(step, device)
        c1, c2 = 1.0 - b1 ** t, 1.0 - b2 ** t
    else:
        c1 = c2 = _f32(1.0, device)
    return torch.stack([
        b1, b2, _f32(eps, device), _f32(weight_decay, device), c1, c2,
        _f32(1.0 if adam_w_mode else 0.0, device),
        _f32(1.0 - beta1 if grad_averaging else 1.0, device),
        gs_over_clip.to(device=device, dtype=torch.float32)])


def flat_lamb_stage1_plain(grads, params, m, v, hp, found_inf=None
                           ) -> Tuple[torch.Tensor, ...]:
    """Plain version of stage 1: ``(m, v, u, p_partials, u_partials)``,
    the elementwise part in the kernel's fp32 operations and order; a
    skipped step gives the old m and v, u = 0 and zero partials."""
    b1, b2, eps, wd, c1, c2, aw, beta3, gsc = hp.unbind()
    p = params
    gl = grads.float() * gsc + ((1.0 - aw) * wd) * p
    m32 = b1 * m.float() + beta3 * gl
    v_new = b2 * v + ((1.0 - b2) * gl) * gl
    u = (m32 / c1) / (torch.sqrt(v_new / c2) + eps) + (aw * wd) * p
    p_parts = (p * p).view(-1, SUB).sum(1)
    u_parts = (u * u).view(-1, SUB).sum(1)
    m_new = m32.to(m.dtype)
    if found_inf is not None:
        zero = torch.zeros((), device=p.device)
        m_new = torch.where(found_inf, m, m_new)
        v_new = torch.where(found_inf, v, v_new)
        u, p_parts, u_parts = (torch.where(found_inf, zero, t)
                               for t in (u, p_parts, u_parts))
    return m_new, v_new, u, p_parts, u_parts


def flat_lamb_stage1_kernel(grads, params, m, v, hp, found_inf=None
                            ) -> Tuple[torch.Tensor, ...]:
    """Launch ``apx_flat_lamb_stage1`` on CUDA buffers: ``(m, v, u,
    p_partials, u_partials)`` as new tensors. Raises on anything the
    kernel does not take (fp32 grads, params and v; fp32 or bf16 m; a
    multiple of 1,024 elements)."""
    who = "flat_lamb_stage1"
    _check_buffer(who, params, multiple=SUB)
    _check(who, "grads", grads, params)
    _check(who, "m", m, params, _M_DTYPES)
    _check(who, "v", v, params)
    _check_device_vector(who, hp, 9, params)
    _check_found(who, found_inf, params)
    m_new, v_new, u = (torch.empty_like(t) for t in (m, v, params))
    p_parts, u_parts = (torch.empty((params.numel() // SUB,),
                                    dtype=torch.float32, device=params.device)
                        for _ in range(2))
    FLAT_LAMB_STAGE1(grads.data_ptr(), params.data_ptr(), m.data_ptr(),
                     v.data_ptr(), m_new.data_ptr(), v_new.data_ptr(),
                     u.data_ptr(), p_parts.data_ptr(), u_parts.data_ptr(),
                     hp.data_ptr(), _ptr(found_inf), params.numel(),
                     int(m.dtype == torch.bfloat16), _stream(params))
    return m_new, v_new, u, p_parts, u_parts


def segment_sums(parts: torch.Tensor, tile_counts: torch.Tensor
                 ) -> torch.Tensor:
    """Per-tensor sums of the partials, span by span in a fixed order
    (``jax.ops.segment_sum`` in the JAX package; ``index_add_`` would
    accumulate with atomics in an order that changes from run to run).
    ``tile_counts`` is ``FlatSpec.tile_counts(8)``: each tensor's span is
    contiguous, so its length is all the layout says."""
    return torch.segment_reduce(parts, "sum", lengths=tile_counts,
                                unsafe=True)


def trust_ratios(p_parts: torch.Tensor, u_parts: torch.Tensor,
                 tile_counts: torch.Tensor) -> torch.Tensor:
    """Stage 2's per-tensor trust ratios ``||p|| / ||u||`` from the
    partials, 1 where either norm is 0."""
    w_norm = torch.sqrt(segment_sums(p_parts, tile_counts))
    u_norm = torch.sqrt(segment_sums(u_parts, tile_counts))
    return torch.where((w_norm > 0) & (u_norm > 0), w_norm / u_norm,
                       torch.ones((), device=w_norm.device))


def lamb_p_limit(p_new, u, p_parts, u_parts, tile_ids, tile_counts,
                 lr) -> torch.Tensor:
    """Error model of ``flat_lamb``'s params between two runs whose
    partials differ only in sum order (kernel vs plain on the card; the
    port vs JAX): per element ``lr |u| |d ratio|`` plus one fp32 ulp of
    p. A tensor of k sub-tiles sums 1,024 k squares in two levels, so each
    norm^2 is within 2 (1024 + k + 1) u of the other run's
    (``sum_sq_limit``); the ratio of the square roots within the sum of
    the two halves plus 4 u (two sqrt, one division, each side); another
    24 u of the update covers ``(lr ratio) u``'s two roundings and 16 u
    of u's own (u is bit-equal between kernel and plain; XLA may
    contract a multiply-add in its u)."""
    ratio = trust_ratios(p_parts, u_parts, tile_counts)
    k = tile_counts.to(torch.float32)
    rel = 2.0 * (SUB + k + 1) * U + 4 * U
    ids = tile_ids.long()
    n_sub = ids.numel()
    step = (float(lr) * ratio * (rel + 24 * U))[ids][:, None] * \
        u.reshape(n_sub, SUB).abs()
    pa = p_new.reshape(n_sub, SUB).abs()
    ulp = torch.nextafter(pa, torch.full_like(pa, float("inf"))) - pa
    return (step + ulp).view_as(p_new)


def lamb_inv_clip(grad_partials: Optional[torch.Tensor],
                  max_grad_norm: float, grad_scale: Scalar = 1.0,
                  grad_norm: Optional[Scalar] = None,
                  device=None) -> torch.Tensor:
    """Stage 1's gradient factor ``grad_scale / clip``, on the device, as
    the JAX ``flat_lamb`` takes it: the global norm of the scaled grads,
    ``sqrt(sum(partials) * gs * gs)`` from the pre-pass's partials (with
    the scale 1 the products are exact), or the caller's ``grad_norm``
    (then ``grad_partials`` may be None, and ``device`` says where); the
    clip ``norm / max_grad_norm`` where the norm exceeds
    ``max_grad_norm`` (1 elsewhere, and when ``max_grad_norm`` is not
    positive)."""
    dev = grad_partials.device if grad_partials is not None else device
    gs = _f32(grad_scale, dev)
    if grad_norm is None:
        grad_norm = torch.sqrt(grad_partials.sum() * gs * gs)
    else:
        grad_norm = _f32(grad_norm, dev)
    max_norm = _f32(max_grad_norm, dev)
    clip = torch.where((max_norm > 0) & (grad_norm > max_norm),
                       grad_norm / max_norm, _f32(1.0, dev))
    return gs / clip


def lamb_stage2(params: torch.Tensor, u: torch.Tensor,
                p_parts: torch.Tensor, u_parts: torch.Tensor,
                tile_ids: torch.Tensor, tile_counts: torch.Tensor, *,
                lr: Scalar, weight_decay: Scalar, use_nvlamb: bool
                ) -> torch.Tensor:
    """Stage 2: per-tensor trust ratios from the partials (1 for tensors
    without weight decay unless NVLAMB), then ``p - (lr * ratio) * u``,
    written over ``u`` (the step's own buffer) and returned."""
    dev = params.device
    ratio = trust_ratios(p_parts, u_parts, tile_counts)
    if not use_nvlamb:
        ratio = torch.where(_f32(weight_decay, dev) == 0.0, _f32(1.0, dev),
                            ratio)
    u.view(p_parts.numel(), SUB).mul_((_f32(lr, dev) * ratio)[tile_ids][
        :, None])
    return torch.sub(params, u, out=u)


def flat_lamb(grads: torch.Tensor, params: torch.Tensor, m: torch.Tensor,
              v: torch.Tensor, tile_ids: torch.Tensor,
              tile_counts: torch.Tensor, *, lr: Scalar, beta1: float,
              beta2: float, eps: float, step: Scalar, weight_decay: Scalar,
              adam_w_mode: bool = True, grad_averaging: bool = True,
              bias_correction: bool = True, use_nvlamb: bool = False,
              max_grad_norm: float = 1.0, grad_scale: Scalar = 1.0,
              grad_norm: Optional[Scalar] = None,
              emit_compute_dtype: Optional[torch.dtype] = None,
              found_inf: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, ...]:
    """One fused LAMB step over flat ``(rows, 128)`` buffers (rows a
    multiple of 8), in the CUDA two-stage split of the JAX package:

    - the pre-pass: ``flat_l2norm_partials`` of the grads gives the
      global norm of the grads times ``grad_scale`` and the clip
      (``lamb_inv_clip``); a caller's ``grad_norm`` (a 0-d tensor or a
      number, the norm of the scaled grads) takes its place, and the
      pre-pass is not run;
    - stage 1 (one kernel): m, v, the raw update u and each sub-tile's
      ``||p||^2`` and ``||u||^2`` partials;
    - stage 2 (PyTorch, as the JAX package leaves it to XLA,
      ``lamb_stage2``): per-tensor sums of the partials over the spans
      of ``tile_counts`` (``FlatSpec.tile_counts(8)``), the trust ratios,
      and ``p - (lr * ratio) * u``, each sub-tile's ratio picked by
      ``tile_ids`` (``FlatSpec.tile_tensor_ids(8)``), both on the
      device.

    ``bias_correction=False`` takes c1 = c2 = 1, ``grad_averaging=False``
    beta3 = 1, as in JAX. ``grad_scale`` multiplies the grads.

    Returns ``(p, m, v)``, or ``(p, m, v, compute)`` with
    ``emit_compute_dtype``. ``m`` may be bf16 (fp32 accumulate);
    ``found_inf`` True writes the old m and v and gives the old p. Nothing
    here reads a value back to the host."""
    if params.dim() != 2 or params.shape[0] % 8:
        raise ValueError(f"flat_lamb needs a (rows, {LANES}) buffer with "
                         f"rows a multiple of 8, got {tuple(params.shape)}")
    hp = lamb_hparams(
        beta1=beta1, beta2=beta2, eps=eps, step=step,
        weight_decay=weight_decay, adam_w_mode=adam_w_mode,
        gs_over_clip=lamb_inv_clip(
            None if grad_norm is not None else flat_l2norm_partials(grads),
            max_grad_norm, grad_scale, grad_norm, params.device),
        device=params.device, bias_correction=bias_correction,
        grad_averaging=grad_averaging)
    stage1 = flat_lamb_stage1_kernel if on_card(params, "params") else \
        flat_lamb_stage1_plain
    m_new, v_new, u, p_parts, u_parts = stage1(grads, params, m, v, hp,
                                               found_inf)
    p_new = lamb_stage2(params, u, p_parts, u_parts, tile_ids, tile_counts,
                        lr=lr, weight_decay=weight_decay,
                        use_nvlamb=use_nvlamb)
    if emit_compute_dtype is not None:
        return p_new, m_new, v_new, p_new.to(emit_compute_dtype)
    return p_new, m_new, v_new


# ---------------------------------------------------------------------------
# SGD (row 17), Adagrad (row 19) and NovoGrad (row 20): in place, as the JAX
# kernels alias params and state
# ---------------------------------------------------------------------------

def _finish_in_place(params, states, new_params, new_states, found_inf,
                     emit_compute_dtype) -> Tuple[torch.Tensor, ...]:
    """The plain versions' tail: ``found_inf`` keeps the old values, the
    new ones are copied into ``params`` and ``states`` (the kernels'
    aliasing), and ``(params, *states[, compute])`` is returned."""
    if found_inf is not None:
        new_params = torch.where(found_inf, params, new_params)
        new_states = [torch.where(found_inf, s, n)
                      for s, n in zip(states, new_states)]
    params.copy_(new_params)
    for s, n in zip(states, new_states):
        s.copy_(n)
    outs = (params,) + tuple(states)
    if emit_compute_dtype is not None:
        outs += (params.to(emit_compute_dtype),)
    return outs


def _check_in_place(who: str, grads, params, states, hp, n_hp, found_inf,
                    emit_compute_dtype, multiple: int = 4) -> None:
    _check_buffer(who, params, multiple=multiple)
    _check(who, "grads", grads, params)
    for name, t, dts in states:
        _check(who, name, t, params, dts)
    _check_device_vector(who, hp, n_hp, params)
    _check_found(who, found_inf, params)
    if emit_compute_dtype not in (None, torch.bfloat16):
        raise RuntimeError(f"{who} kernel casts out to bf16 only, not "
                           f"{emit_compute_dtype}")


def _cast_out(params, emit_compute_dtype) -> Optional[torch.Tensor]:
    return None if emit_compute_dtype is None else \
        torch.empty_like(params, dtype=torch.bfloat16)


def sgd_hparams(*, lr: Scalar, momentum: float, dampening: float,
                weight_decay: Scalar, nesterov: bool,
                wd_after_momentum: bool, first_run, grad_scale: Scalar,
                device) -> torch.Tensor:
    """The (9,) fp32 vector of ``_sgd_kernel``, on ``device``, in its
    order: ``lr, momentum, dampening, wd, nesterov, wd_after, first,
    grad_scale, use_momentum``; ``first_run`` may be a 0-d bool tensor on
    the device (the step count is 0)."""
    first = first_run.to(device=device, dtype=torch.float32) \
        if isinstance(first_run, torch.Tensor) else \
        _f32(1.0 if first_run else 0.0, device)
    return torch.stack([
        _f32(lr, device), _f32(momentum, device), _f32(dampening, device),
        _f32(weight_decay, device), _f32(1.0 if nesterov else 0.0, device),
        _f32(1.0 if wd_after_momentum else 0.0, device), first,
        _f32(grad_scale, device), _f32(1.0 if momentum > 0 else 0.0, device)])


def flat_sgd_plain(grads, params, buf, hp, found_inf=None,
                   emit_compute_dtype=None) -> Tuple[torch.Tensor, ...]:
    """Plain version of the kernel: the same fp32 operations in the same
    order, written into ``params`` and ``buf``; returns ``(params, buf[,
    compute])``."""
    lr, mom, damp, wd, nest, wda, first, gs, use_mom = hp.unbind()
    p = params
    g = grads.float() * gs + ((1.0 - wda) * wd) * p
    b = buf.float()
    seeded = torch.where(first > 0, g, mom * b + (1.0 - damp) * g)
    d = torch.where(nest > 0, g + mom * seeded, seeded)
    d = torch.where(use_mom > 0, d, g)
    new_buf = torch.where(use_mom > 0, seeded, b).to(buf.dtype)
    p_new = p - lr * (d + (wda * wd) * p)
    return _finish_in_place(params, [buf], p_new, [new_buf], found_inf,
                            emit_compute_dtype)


def flat_sgd_kernel(grads, params, buf, hp, found_inf=None,
                    emit_compute_dtype=None) -> Tuple[torch.Tensor, ...]:
    """Launch ``apx_flat_sgd`` on CUDA buffers, updating ``params`` and
    ``buf`` in place: ``(params, buf[, compute])``. Raises on anything the
    kernel does not take (fp32 grads and params; fp32 or bf16 buf; a
    bf16 cast-out)."""
    who = "flat_sgd"
    _check_in_place(who, grads, params, [("buf", buf, _M_DTYPES)], hp, 9,
                    found_inf, emit_compute_dtype)
    pc = _cast_out(params, emit_compute_dtype)
    FLAT_SGD(grads.data_ptr(), params.data_ptr(), buf.data_ptr(), _ptr(pc),
             hp.data_ptr(), _ptr(found_inf), params.numel(),
             int(buf.dtype == torch.bfloat16), _stream(params))
    return (params, buf) if pc is None else (params, buf, pc)


def flat_sgd(grads: torch.Tensor, params: torch.Tensor,
             momentum_buf: torch.Tensor, *, lr: Scalar, momentum: float,
             dampening: float, weight_decay: Scalar, nesterov: bool,
             wd_after_momentum: bool, first_run, grad_scale: Scalar = 1.0,
             emit_compute_dtype: Optional[torch.dtype] = None,
             found_inf: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, ...]:
    """One fused SGD step over flat buffers (the JAX ``flat_sgd``: the
    ``first_run`` buffer seeding, ``wd_after_momentum``, Nesterov).
    ``params`` and ``momentum_buf`` are updated in place and returned as
    ``(params, buf)``, or ``(params, buf, compute)`` with
    ``emit_compute_dtype``. ``momentum_buf`` may be bf16 (fp32
    accumulate); it is written only with momentum. ``first_run`` may be a
    0-d bool tensor on the device; ``found_inf`` True leaves params and
    buffer as they were."""
    hp = sgd_hparams(lr=lr, momentum=momentum, dampening=dampening,
                     weight_decay=weight_decay, nesterov=nesterov,
                     wd_after_momentum=wd_after_momentum,
                     first_run=first_run, grad_scale=grad_scale,
                     device=params.device)
    fn = flat_sgd_kernel if on_card(params, "params") else flat_sgd_plain
    return fn(grads, params, momentum_buf, hp, found_inf, emit_compute_dtype)


def adagrad_hparams(*, lr: Scalar, eps: float, weight_decay: Scalar,
                    adagrad_w_mode: bool, grad_scale: Scalar,
                    device) -> torch.Tensor:
    """The (5,) fp32 vector of ``_adagrad_kernel``: ``lr, eps, wd,
    adagrad_w, grad_scale``."""
    return torch.stack([
        _f32(lr, device), _f32(eps, device), _f32(weight_decay, device),
        _f32(1.0 if adagrad_w_mode else 0.0, device),
        _f32(grad_scale, device)])


def flat_adagrad_plain(grads, params, gsum, hp, found_inf=None,
                       emit_compute_dtype=None) -> Tuple[torch.Tensor, ...]:
    """Plain version of the kernel, written into ``params`` and ``gsum``:
    ``(params, gsum[, compute])``."""
    lr, eps, wd, w, gs = hp.unbind()
    p = params
    g = grads.float() * gs + ((1.0 - w) * wd) * p
    s = gsum + g * g
    p_new = p - lr * (g / (torch.sqrt(s) + eps) + (w * wd) * p)
    return _finish_in_place(params, [gsum], p_new, [s], found_inf,
                            emit_compute_dtype)


def flat_adagrad_kernel(grads, params, gsum, hp, found_inf=None,
                        emit_compute_dtype=None) -> Tuple[torch.Tensor, ...]:
    """Launch ``apx_flat_adagrad`` on CUDA fp32 buffers, updating
    ``params`` and ``gsum`` in place."""
    who = "flat_adagrad"
    _check_in_place(who, grads, params, [("sum", gsum, (torch.float32,))],
                    hp, 5, found_inf, emit_compute_dtype)
    pc = _cast_out(params, emit_compute_dtype)
    FLAT_ADAGRAD(grads.data_ptr(), params.data_ptr(), gsum.data_ptr(),
                 _ptr(pc), hp.data_ptr(), _ptr(found_inf), params.numel(),
                 _stream(params))
    return (params, gsum) if pc is None else (params, gsum, pc)


def flat_adagrad(grads: torch.Tensor, params: torch.Tensor,
                 gsum: torch.Tensor, *, lr: Scalar, eps: float,
                 weight_decay: Scalar, adagrad_w_mode: bool = False,
                 grad_scale: Scalar = 1.0,
                 emit_compute_dtype: Optional[torch.dtype] = None,
                 found_inf: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, ...]:
    """One fused Adagrad step over flat fp32 buffers (the JAX
    ``flat_adagrad``): ``params`` and ``gsum`` updated in place and
    returned, with the cast-out appended for ``emit_compute_dtype``;
    ``found_inf`` True leaves them as they were."""
    hp = adagrad_hparams(lr=lr, eps=eps, weight_decay=weight_decay,
                         adagrad_w_mode=adagrad_w_mode,
                         grad_scale=grad_scale, device=params.device)
    fn = flat_adagrad_kernel if on_card(params, "params") else \
        flat_adagrad_plain
    return fn(grads, params, gsum, hp, found_inf, emit_compute_dtype)


def novograd_hparams(*, lr: Scalar, beta1: float, step: Scalar,
                     weight_decay: Scalar, grad_averaging: bool,
                     bias_correction: bool, reg_inside_moment: bool,
                     grad_scale: Scalar, device) -> torch.Tensor:
    """The (7,) fp32 vector of ``_novograd_kernel``: ``lr, b1, beta3, wd,
    c1, reg_inside, grad_scale``; beta3 = 1 - beta1 taken in float64 and
    rounded (1.0 without grad averaging), c1 in fp32 from the step (1.0
    without bias correction), as the JAX flat path takes them."""
    b1 = _f32(beta1, device)
    c1 = 1.0 - b1 ** _f32(step, device) if bias_correction else \
        _f32(1.0, device)
    return torch.stack([
        _f32(lr, device), b1,
        _f32(1.0 - beta1 if grad_averaging else 1.0, device),
        _f32(weight_decay, device), c1,
        _f32(1.0 if reg_inside_moment else 0.0, device),
        _f32(grad_scale, device)])


def novograd_moments(grad_partials: torch.Tensor, v: torch.Tensor,
                     tile_counts: torch.Tensor, tile_ids: torch.Tensor, *,
                     beta2: float, eps: float, step: Scalar,
                     bias_correction: bool, init_zero: bool,
                     grad_scale: Scalar = 1.0
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """NovoGrad's per-tensor part, on the device: ``(v_new, denom)``.
    ||g||^2 of each tensor from the L2 partials (span sums over
    ``tile_counts``, times grad_scale^2), ``v_new`` its EMA (``gsq``
    itself on step 1 unless ``init_zero``), and each sub-tile's
    ``sqrt(v_new / c2) + eps`` picked by ``tile_ids``, 1 where that is 0
    (JAX's block-pad rows)."""
    dev = v.device
    gs = _f32(grad_scale, dev)
    gsq = segment_sums(grad_partials[:tile_ids.numel()], tile_counts) \
        * gs * gs
    b2 = _f32(beta2, dev)
    t = _f32(step, dev)
    ema = b2 * v + (1.0 - b2) * gsq
    v_new = ema if init_zero else torch.where(t <= 1, gsq, ema)
    c2 = 1.0 - b2 ** t if bias_correction else _f32(1.0, dev)
    denom = (torch.sqrt(v_new / c2) + _f32(eps, dev))[tile_ids]
    return v_new, torch.where(denom == 0, _f32(1.0, dev), denom)


def flat_novograd_plain(grads, params, m, denom, hp, found_inf=None,
                        emit_compute_dtype=None
                        ) -> Tuple[torch.Tensor, ...]:
    """Plain version of the elementwise pass, written into ``params`` and
    ``m``: ``(params, m[, compute])``; ``denom`` is one fp32 a sub-tile."""
    lr, b1, beta3, wd, c1, reg, gs = hp.unbind()
    p = params
    n_sub = denom.numel()
    gn = ((grads.float() * gs).view(n_sub, SUB) / denom[:, None]).view_as(p)
    gn = gn + (reg * wd) * p
    m32 = b1 * m.float() + beta3 * gn
    p_new = p - lr * (m32 / c1 + ((1.0 - reg) * wd) * p)
    return _finish_in_place(params, [m], p_new, [m32.to(m.dtype)],
                            found_inf, emit_compute_dtype)


def flat_novograd_kernel(grads, params, m, denom, hp, found_inf=None,
                         emit_compute_dtype=None
                         ) -> Tuple[torch.Tensor, ...]:
    """Launch ``apx_flat_novograd`` on CUDA buffers, updating ``params``
    and ``m`` in place. Raises on anything the kernel does not take (fp32
    grads and params, fp32 or bf16 m, a multiple of 1,024 elements, one
    fp32 denom a sub-tile)."""
    who = "flat_novograd"
    _check_in_place(who, grads, params, [("m", m, _M_DTYPES)], hp, 7,
                    found_inf, emit_compute_dtype, multiple=SUB)
    _check_device_vector(who, denom, params.numel() // SUB, params)
    pc = _cast_out(params, emit_compute_dtype)
    FLAT_NOVOGRAD(grads.data_ptr(), params.data_ptr(), m.data_ptr(),
                  denom.data_ptr(), _ptr(pc), hp.data_ptr(), _ptr(found_inf),
                  params.numel(), int(m.dtype == torch.bfloat16),
                  _stream(params))
    return (params, m) if pc is None else (params, m, pc)


def flat_novograd(grads: torch.Tensor, params: torch.Tensor,
                  m: torch.Tensor, v: torch.Tensor, tile_ids: torch.Tensor,
                  tile_counts: torch.Tensor, *, lr: Scalar, beta1: float,
                  beta2: float, eps: float, step: Scalar,
                  weight_decay: Scalar, grad_averaging: bool = True,
                  bias_correction: bool = True,
                  reg_inside_moment: bool = False, init_zero: bool = False,
                  grad_scale: Scalar = 1.0,
                  emit_compute_dtype: Optional[torch.dtype] = None,
                  found_inf: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, ...]:
    """One fused NovoGrad step over flat ``(rows, 128)`` buffers (rows a
    multiple of 8), as the JAX ``flat_novograd`` splits it:

    - the pre-pass: ``flat_l2norm_partials`` of the grads (row 15's
      kernel), summed per tensor over the spans of ``tile_counts``
      (``FlatSpec.tile_counts(8)``) into each tensor's ||g||^2;
    - the ``(num_tensors,)`` second moment ``v`` and each sub-tile's
      denominator, in PyTorch on the device (``novograd_moments``);
    - one elementwise pass over p and m (``_novograd_kernel``).

    ``params`` and ``m`` are updated in place; returns ``(params, m,
    v_new)``, or ``(params, m, v_new, compute)`` with
    ``emit_compute_dtype``. ``m`` may be bf16 (fp32 accumulate).
    ``found_inf`` True leaves params and m as they were and gives the
    old v. Nothing here reads a value back to the host."""
    if params.dim() != 2 or params.shape[0] % 8:
        raise ValueError(f"flat_novograd needs a (rows, {LANES}) buffer "
                         f"with rows a multiple of 8, got "
                         f"{tuple(params.shape)}")
    v_new, denom = novograd_moments(
        flat_l2norm_partials(grads), v, tile_counts, tile_ids, beta2=beta2,
        eps=eps, step=step, bias_correction=bias_correction,
        init_zero=init_zero, grad_scale=grad_scale)
    hp = novograd_hparams(lr=lr, beta1=beta1, step=step,
                          weight_decay=weight_decay,
                          grad_averaging=grad_averaging,
                          bias_correction=bias_correction,
                          reg_inside_moment=reg_inside_moment,
                          grad_scale=grad_scale, device=params.device)
    fn = flat_novograd_kernel if on_card(params, "params") else \
        flat_novograd_plain
    outs = fn(grads, params, m, denom, hp, found_inf, emit_compute_dtype)
    if found_inf is not None:
        v_new = torch.where(found_inf, v, v_new)
    return outs[:2] + (v_new,) + outs[2:]

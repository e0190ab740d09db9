"""Flat-buffer optimizer kernels (counterpart of
``apex_tpu/multi_tensor_apply/kernels.py``); this slice ports
``flat_adam`` (the Pallas ``_adam_kernel``), the one the BERT step's
``FusedAdam(use_flat_kernel=True)`` runs.

The nine hyperparameters are one fp32 vector on the device (the JAX
kernel's SMEM vector): ``lr, beta1, beta2, eps, weight_decay, c1, c2,
adam_w, grad_scale``, with ``c1 = 1 - beta1^t`` and ``c2 = 1 - beta2^t``
computed there from the step, so a step never waits on the host.
``found_inf`` (a 0-d bool on the device, apex's ``noop_flag``) makes the
step write the old values.

Outputs are new tensors: the inputs, the caller's optimizer state among
them, stay as they were (JAX aliases them under jit, a pure update).

Dispatch: a CUDA tensor launches the hand-written kernel
(``csrc/multi_tensor.cu``) or raises; a CPU tensor takes the plain
PyTorch version below, which repeats the kernel's arithmetic operation
for operation, so on the card the two agree bit for bit.
"""

import ctypes
from typing import Optional, Tuple, Union

import torch

from apex_tpu_torch.utils.cuda_build import CudaLibrary, Kernel
from apex_tpu_torch.utils.platform import on_card

LIB = CudaLibrary("multi_tensor")
_P = ctypes.c_void_p
FLAT_ADAM = Kernel(LIB, "apx_flat_adam",
                   [_P] * 10 + [ctypes.c_longlong, ctypes.c_int, _P])
_M_DTYPES = (torch.float32, torch.bfloat16)

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


def _check(name: str, t: torch.Tensor, like: torch.Tensor,
           dtypes=(torch.float32,)) -> None:
    if t.device != like.device or t.shape != like.shape \
            or t.dtype not in dtypes or not t.is_contiguous() \
            or t.data_ptr() % 16:
        raise RuntimeError(
            f"flat_adam kernel needs a contiguous, 16-byte aligned "
            f"{tuple(like.shape)} {name} of {[str(d) for d in dtypes]} on "
            f"{like.device}, got {tuple(t.shape)} {t.dtype} on {t.device}")


def flat_adam_kernel(grads, params, m, v, hp, found_inf=None,
                     emit_compute_dtype=None) -> Tuple[torch.Tensor, ...]:
    """Launch ``csrc/multi_tensor.cu`` on CUDA tensors: ``(p, m, v[,
    compute])`` as new tensors. Raises on anything the kernel does not
    take (fp32 grads, params and v; fp32 or bf16 m; a bf16 cast-out)."""
    if params.device.type != "cuda":
        raise RuntimeError(f"flat_adam kernel needs CUDA tensors, got "
                           f"params on {params.device}")
    _check("params", params, params)
    _check("grads", grads, params)
    _check("m", m, params, _M_DTYPES)
    _check("v", v, params)
    if params.numel() % 4:
        raise RuntimeError("flat_adam kernel needs a multiple of 4 "
                           "elements (a (rows, 128) buffer)")
    if hp.shape != (9,) or hp.dtype != torch.float32 \
            or hp.device != params.device or not hp.is_contiguous():
        raise RuntimeError("flat_adam kernel needs the (9,) fp32 "
                           f"hyperparameters on {params.device}")
    if found_inf is not None and (found_inf.shape != () or found_inf.dtype
                                  != torch.bool or found_inf.device
                                  != params.device):
        raise RuntimeError("flat_adam kernel needs found_inf as a 0-d "
                           f"bool on {params.device}")
    if emit_compute_dtype not in (None, torch.bfloat16):
        raise RuntimeError(f"flat_adam kernel casts out to bf16 only, not "
                           f"{emit_compute_dtype}")
    p_new, m_new, v_new = (torch.empty_like(t) for t in (params, m, v))
    pc = None if emit_compute_dtype is None else \
        torch.empty_like(params, dtype=torch.bfloat16)
    FLAT_ADAM(grads.data_ptr(), params.data_ptr(), m.data_ptr(), v.data_ptr(),
              p_new.data_ptr(), m_new.data_ptr(), v_new.data_ptr(),
              None if pc is None else pc.data_ptr(), hp.data_ptr(),
              None if found_inf is None else found_inf.data_ptr(),
              params.numel(), int(m.dtype == torch.bfloat16),
              torch.cuda.current_stream(params.device).cuda_stream)
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

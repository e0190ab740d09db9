"""Apex-shaped multi-tensor API over lists of tensors (counterpart of
``apex_tpu/multi_tensor_apply/multi_tensor_apply.py``).

The list ops are plain PyTorch, as the JAX ones are plain ``jnp``; the
flat-buffer kernels (``kernels.py``) are the path for callers that keep
their state packed. Ops are functional: they RETURN new tensors instead
of writing an output list in place, and return ``found_inf`` (a 0-d
bool on the tensors' device) instead of setting an ``overflow_buf``.
"""

from typing import List, Sequence, Tuple

import torch

from apex_tpu_torch.amp.scaler import _all_finite


def _found_inf(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    # the scaler's check: magnitudes past the storage dtype's max count
    return torch.logical_not(_all_finite(list(tensors)))


def multi_tensor_scale(tensors: Sequence[torch.Tensor], scale,
                       out_dtypes=None
                       ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """``(tensors * scale, found_inf)``, ref ``amp_C.multi_tensor_scale``.
    Overflow is judged on the incoming values, as the reference's
    ``overflow_buf`` (a scaled value may shrink back into range)."""
    s = torch.as_tensor(scale, dtype=torch.float32)
    found_inf = _found_inf(tensors)
    if out_dtypes is None:
        out_dtypes = [t.dtype for t in tensors]
    out = [(t.float() * s.to(t.device)).to(d)
           for t, d in zip(tensors, out_dtypes)]
    return out, found_inf


def multi_tensor_axpby(a, xs: Sequence[torch.Tensor], b,
                       ys: Sequence[torch.Tensor], out_dtypes=None
                       ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """``a * x + b * y`` per pair, ref ``amp_C.multi_tensor_axpby``;
    ``out_dtypes`` (from the apex out-tensor list) selects the result
    dtypes, default y's. ``found_inf`` is judged on the results."""
    a = torch.as_tensor(a, dtype=torch.float32)
    b = torch.as_tensor(b, dtype=torch.float32)
    if out_dtypes is None:
        out_dtypes = [y.dtype for y in ys]
    out = [(a.to(x.device) * x.float() + b.to(x.device) * y.float()).to(d)
           for x, y, d in zip(xs, ys, out_dtypes)]
    return out, _found_inf(out)


def multi_tensor_l2norm(tensors: Sequence[torch.Tensor],
                        per_tensor: bool = False):
    """Global L2 norm (and per-tensor norms with ``per_tensor``) in fp32,
    ref ``amp_C.multi_tensor_l2norm``."""
    if not tensors:
        z = torch.zeros((), dtype=torch.float32)
        return (z, torch.zeros((0,), dtype=torch.float32)) if per_tensor \
            else z
    sq = torch.stack([torch.sum(torch.square(t.float())) for t in tensors])
    total = torch.sqrt(sq.sum())
    if per_tensor:
        return total, torch.sqrt(sq)
    return total


class MultiTensorApply:
    """The apex calling convention ``MultiTensorApply(chunk_size)(op,
    noop_flag, tensor_lists, *args)`` for the ops ``"scale"`` (``[src,
    dst]``) and ``"axpby"`` (``[xs, ys, outs]``). ``chunk_size`` and
    ``noop_flag`` are ignored (found_inf is returned, not stored), and an
    output list selects the out dtypes only (results are returned)."""

    def __init__(self, chunk_size: int = 2048 * 32):
        self.chunk_size = chunk_size

    def __call__(self, op: str, noop_flag, tensor_lists, *args):
        if op == "scale":
            src, *rest = tensor_lists
            out_dtypes = [t.dtype for t in rest[0]] if rest else None
            return multi_tensor_scale(src, args[0], out_dtypes)
        if op == "axpby":
            xs, ys, *rest = tensor_lists
            out_dtypes = [t.dtype for t in rest[0]] if rest else None
            return multi_tensor_axpby(args[0], xs, args[1], ys, out_dtypes)
        raise ValueError(f"unknown multi-tensor op: {op!r}")


multi_tensor_applier = MultiTensorApply()

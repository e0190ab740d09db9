"""The O1 autocast context (counterpart of ``apex_tpu/amp/autocast.py``).

The reference patches torch functions with casting shims for O1. Here,
as in the JAX package, the port's own ops and modules consult a
thread-local autocast context before they run: ``cast_args`` applies
the op policy of :mod:`apex_tpu_torch.amp.lists`. The JAX package reads
the context at trace time; eager PyTorch reads it at call time, which
is the same thing: entering or leaving ``autocast`` around a call
switches the casts of that call.

This is not ``torch.autocast``: its op lists are PyTorch's (it would
cast layer norms, softmaxes and adds by its own rules and change what
the hand kernels receive). Outside the context ``cast_args`` returns
its arguments as they are, so a step that never enters it runs exactly
the ops it ran before.

The casts are autograd ops: a gradient reaching a bf16 copy flows back
to the fp32 leaf as fp32, as JAX's transpose of ``astype`` gives it.
"""

import contextlib
import threading
from typing import Iterable, Optional

import torch

from apex_tpu_torch.amp import lists

_state = threading.local()


def _stack():
    if not hasattr(_state, "stack"):
        _state.stack = []
    return _state.stack


@contextlib.contextmanager
def autocast(dtype: torch.dtype = torch.bfloat16, enabled: bool = True):
    """Enable O1 op-policy casting within the context."""
    _stack().append(dtype if enabled else None)
    try:
        yield
    finally:
        _stack().pop()


def autocast_dtype() -> Optional[torch.dtype]:
    """The active autocast compute dtype, or None when disabled."""
    s = _stack()
    return s[-1] if s else None


def is_autocast_enabled() -> bool:
    return autocast_dtype() is not None


# the float dtypes with an implicit promotion path in JAX's lattice
_PROMOTABLE = (torch.float16, torch.bfloat16, torch.float32, torch.float64)


def _widest(dtypes: Iterable[torch.dtype]) -> Optional[torch.dtype]:
    """Promotion target for mixed float inputs, on JAX's lattice: f16 +
    bf16 gives f32 (neither holds the other). ``torch.promote_types`` on
    dtypes agrees with it on these four; ``torch.result_type`` on
    tensors would not (it treats 0-d tensors as weaker)."""
    floats = [d for d in dtypes if d in _PROMOTABLE]
    if not floats:
        return None
    out = floats[0]
    for d in floats[1:]:
        out = torch.promote_types(out, d)
    return out


def cast_args(op_name: str, *args):
    """Apply the op policy to the floating-point tensor arguments;
    returns a tuple (the arguments as they are outside the context)."""
    dtype = autocast_dtype()
    if dtype is None:
        return args
    policy = lists.policy_for(op_name)
    if policy == "passthrough":
        return args

    def is_float(a):
        return isinstance(a, torch.Tensor) and a.is_floating_point()

    if policy == "fp16":
        target = dtype
    elif policy == "fp32":
        target = torch.float32
    else:  # promote
        target = _widest([a.dtype for a in args if is_float(a)])
        if target is None:
            return args
    return tuple(a.to(target) if is_float(a) and a.dtype != target else a
                 for a in args)

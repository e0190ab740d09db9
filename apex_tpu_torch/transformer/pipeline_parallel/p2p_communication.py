"""Stage-to-stage exchange of activations and gradients over the
``pipe`` axis (counterpart of
``apex_tpu/transformer/pipeline_parallel/p2p_communication.py``;
reference: ``apex/transformer/pipeline_parallel/p2p_communication.py ::
_communicate``).

Each exchange is one ring shift of every leaf along this rank's ``pipe``
group (``tensor_parallel.mappings.shift``: one ``isend`` and one
``irecv`` a leaf, both waited on): activations go **+1**, gradients
**-1**. Every stage posts the same exchange at the same point, so a
send and its matching receive are one call, as the JAX package's
``lax.ppermute`` is; the wraparound link (last stage to first) is in the
ring and the schedules ignore what it brings. Shapes are static, so the
reference's shape handshake has no counterpart. The shift's backward is
the reverse shift, as JAX transposes a ``ppermute``.
"""

from typing import Any

from apex_tpu_torch.transformer import parallel_state as ps
from apex_tpu_torch.transformer.tensor_parallel.mappings import shift
from apex_tpu_torch.utils.tree import tree_map


def _shift(x: Any, step: int) -> Any:
    """Every leaf of ``x`` shifted ``step`` stages along ``pipe``."""
    return tree_map(lambda a: shift(a, ps.PIPE_AXIS, step), x)


def send_forward_recv_forward(output_tensor: Any) -> Any:
    """Send activations to the next stage; return what the previous stage
    sent us (ref: ``send_forward`` + ``recv_forward`` fused)."""
    return _shift(output_tensor, +1)


def send_backward_recv_backward(input_tensor_grad: Any) -> Any:
    """Send grads to the previous stage; return the next stage's grads
    (ref: ``send_backward`` + ``recv_backward`` fused)."""
    return _shift(input_tensor_grad, -1)


def send_forward_recv_backward(output_tensor: Any,
                               input_tensor_grad: Any) -> Any:
    """1F1B steady-state exchange: activations go +1 while grads go -1
    (ref: ``send_forward_recv_backward``). Returns (recv_fwd, recv_bwd)."""
    return _shift(output_tensor, +1), _shift(input_tensor_grad, -1)


def send_backward_recv_forward(input_tensor_grad: Any,
                               output_tensor: Any) -> Any:
    """Mirror of :func:`send_forward_recv_backward`; returns
    (recv_bwd, recv_fwd)."""
    return _shift(input_tensor_grad, -1), _shift(output_tensor, +1)


# Lone send/recv: a send and its matching receive are ONE exchange here,
# so code ported from the reference that calls send_forward(x) and then
# recv_forward(...) would shift twice. The lone names fail fast with the
# replacement, as in the JAX package.

def _one_collective(name: str, repl: str):
    def guard(*_a, **_k):
        raise RuntimeError(
            f"p2p_communication.{name}: under SPMD the send and its "
            f"matching recv are a single collective — call {repl}(x) "
            f"EXACTLY ONCE per exchange (it both sends and returns the "
            f"received value). Calling lone send_*/recv_* pairs as in "
            f"the reference would ppermute twice and double-shift.")
    guard.__name__ = name
    guard.__doc__ = (f"Removed alias; use :func:`{repl}` once per "
                     f"exchange (see module docstring).")
    return guard


send_forward = _one_collective("send_forward", "send_forward_recv_forward")
recv_forward = _one_collective("recv_forward", "send_forward_recv_forward")
send_backward = _one_collective("send_backward",
                                "send_backward_recv_backward")
recv_backward = _one_collective("recv_backward",
                                "send_backward_recv_backward")

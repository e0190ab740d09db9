"""Multi-tensor engine (counterpart of ``apex_tpu/multi_tensor_apply``):
the flat ``(rows, 128)`` buffer layout and the flat-buffer kernels
(``flat_adam`` in this slice)."""

from apex_tpu_torch.multi_tensor_apply.flatten import (  # noqa: F401
    FlatSpec,
    flatten_pytree,
    flatten_tensors,
    make_spec,
    unflatten_pytree,
    unflatten_tensors,
    zeros_buffer,
)
from apex_tpu_torch.multi_tensor_apply import kernels  # noqa: F401

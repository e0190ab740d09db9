"""Multi-tensor engine (counterpart of ``apex_tpu/multi_tensor_apply``):
the list ops of the apex API, the flat ``(rows, 128)`` buffer layout and
the flat-buffer kernels (``flat_adam``, ``flat_lamb``, ``flat_sgd``,
``flat_adagrad``, ``flat_novograd``, ``flat_scale``, ``flat_axpby``,
``flat_l2norm``)."""

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
from apex_tpu_torch.multi_tensor_apply.multi_tensor_apply import (  # noqa: F401
    MultiTensorApply,
    multi_tensor_applier,
    multi_tensor_axpby,
    multi_tensor_l2norm,
    multi_tensor_scale,
)

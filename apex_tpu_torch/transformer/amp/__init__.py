"""Grad scaler for tensor- and pipeline-parallel training (counterpart
of ``apex_tpu/transformer/amp/__init__.py``, the reference's Megatron
``GradScaler``): the core ``LossScaler`` of ``amp``, whose ``unscale``
also ORs ``found_inf`` over the model-parallel ranks, so a rank that
overflowed makes every rank skip the step.

The JAX package ORs over the mesh axes that the enclosing ``shard_map``
binds (``lax.pmax``), skipping the unbound ones. Here each rank is a
process: the OR is an ``all_reduce(MAX)`` over this rank's
``parallel_state`` group along the tensor axis and then along the
pipeline axis. An axis of size 1, or no mesh at all (the counterparts
of an unbound axis), is skipped; any other error propagates, as the
reference insists: failing open would let the ranks' optimizer states
part.
"""

from typing import Any, Tuple

import torch
import torch.distributed as dist

from apex_tpu_torch.amp.scaler import LossScaler, LossScalerState  # noqa: F401
from apex_tpu_torch.transformer import parallel_state as ps

# (world size, this rank's group) along the tensor and the pipeline axis
_AXES = ((ps.get_tensor_model_parallel_world_size,
          ps.get_tensor_model_parallel_group),
         (ps.get_pipeline_model_parallel_world_size,
          ps.get_pipeline_model_parallel_group))


class GradScaler(LossScaler):
    """``unscale`` additionally ORs found_inf over the tensor and pipeline
    groups of ``parallel_state`` (each rank calls it, as each calls the
    reference's)."""

    def unscale(self, grads: Any, state: LossScalerState
                ) -> Tuple[Any, torch.Tensor]:
        grads, found_inf = super().unscale(grads, state)
        if not ps.model_parallel_is_initialized():
            return grads, found_inf
        for size, group in _AXES:
            if size() > 1:
                flag = found_inf.to(torch.int32)
                dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=group())
                found_inf = flag > 0
        return grads, found_inf

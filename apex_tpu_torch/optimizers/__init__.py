"""Fused optimizers: FusedAdam and FusedLAMB, each on the tree path and
the flat path (the others wait for later slices). Functional API:
``state = opt.init(params)``; ``params, state = opt.step(grads, params,
state, found_inf=...)``."""

from apex_tpu_torch.optimizers.fused_adam import AdamState, FusedAdam  # noqa: F401
from apex_tpu_torch.optimizers.fused_lamb import FusedLAMB, LambState  # noqa: F401

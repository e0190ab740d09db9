"""Fused optimizers: FusedAdam on the tree path (the others wait for
later slices). Functional API: ``state = opt.init(params)``; ``params,
state = opt.step(grads, params, state, found_inf=...)``."""

from apex_tpu_torch.optimizers.fused_adam import AdamState, FusedAdam  # noqa: F401

"""Weight-norm reparameterization (counterpart of
``apex_tpu/reparameterization``)."""

from apex_tpu_torch.reparameterization.weight_norm import (  # noqa: F401
    apply_weight_norm,
    compute_weight,
    remove_weight_norm,
)

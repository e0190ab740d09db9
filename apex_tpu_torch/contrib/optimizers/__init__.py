"""Distributed (ZeRO) optimizers (counterpart of
``apex_tpu/contrib/optimizers``; reference: ``apex/contrib/optimizers``)."""

from apex_tpu_torch.contrib.optimizers.distributed_fused_adam import (  # noqa: F401,E501
    DistributedAdamState,
    DistributedFusedAdam,
)
from apex_tpu_torch.contrib.optimizers.distributed_fused_lamb import (  # noqa: F401,E501
    DistributedFusedLAMB,
    DistributedLambState,
)

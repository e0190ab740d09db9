"""The spatially parallel bottleneck block (counterpart of
``apex_tpu/contrib/bottleneck``)."""

from apex_tpu_torch.contrib.bottleneck.bottleneck import (  # noqa: F401
    init_spatial_bottleneck,
    spatial_bottleneck,
    spatial_parallel_bottleneck,
)

"""Group BatchNorm (counterpart of ``apex_tpu/contrib/groupbn``)."""

from apex_tpu_torch.contrib.groupbn.batch_norm import (  # noqa: F401
    BatchNorm2d_NHWC,
)

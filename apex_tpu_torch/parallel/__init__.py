"""Data-parallel utilities on ``torch.distributed`` (counterpart of
``apex_tpu/parallel/__init__.py``): ``DistributedDataParallel``,
``SyncBatchNorm`` and ``convert_syncbn_model``, ``LARC``, and the
launch bootstrap in ``multiproc``."""

from apex_tpu_torch.parallel import multiproc  # noqa: F401
from apex_tpu_torch.parallel.LARC import LARC  # noqa: F401
from apex_tpu_torch.parallel.distributed import (  # noqa: F401
    DistributedDataParallel,
)
from apex_tpu_torch.parallel.sync_batchnorm import (  # noqa: F401
    SyncBatchNorm,
    convert_syncbn_model,
)

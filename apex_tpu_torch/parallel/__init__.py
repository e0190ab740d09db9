"""Data-parallel utilities on ``torch.distributed`` (counterpart of
``apex_tpu/parallel/__init__.py``): ``DistributedDataParallel``,
``SyncBatchNorm`` and ``convert_syncbn_model``, and the launch
bootstrap in ``multiproc``. ``LARC`` waits for the optimizers' ``lr=``
and ``weight_decay=`` step arguments (ROADMAP.md queue A, A5)."""

from apex_tpu_torch.parallel import multiproc  # noqa: F401
from apex_tpu_torch.parallel.distributed import (  # noqa: F401
    DistributedDataParallel,
)
from apex_tpu_torch.parallel.sync_batchnorm import (  # noqa: F401
    SyncBatchNorm,
    convert_syncbn_model,
)

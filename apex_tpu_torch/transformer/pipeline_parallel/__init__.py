"""Pipeline parallelism (counterpart of
``apex_tpu/transformer/pipeline_parallel``; reference:
``apex/transformer/pipeline_parallel``).

- :mod:`microbatches` — the microbatch calculator (and batch-size rampup)
- :mod:`p2p_communication` — stage-to-stage exchange over the ``pipe``
  group's ring
- :mod:`schedules` — no pipelining, 1F1B and interleaved schedules
  behind :func:`get_forward_backward_func`
"""

from apex_tpu_torch.transformer.pipeline_parallel import (  # noqa: F401
    microbatches,
    p2p_communication,
    schedules,
)
from apex_tpu_torch.transformer.pipeline_parallel.microbatches import (  # noqa: F401,E501
    get_current_global_batch_size,
    get_num_microbatches,
    setup_microbatch_calculator,
    update_num_microbatches,
)
from apex_tpu_torch.transformer.pipeline_parallel.schedules import (  # noqa: F401
    PipelineModel,
    forward_backward_no_pipelining,
    forward_backward_pipelining_with_interleaving,
    forward_backward_pipelining_without_interleaving,
    get_forward_backward_func,
    split_batch_into_microbatches,
)

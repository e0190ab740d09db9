"""Serving: KV-cached incremental decode for the port's GPT (dense
cache, greedy continuous batching; bf16/fp32 or weight-only int8
params, detected by ``DecodeEngine``). See ``scheduler.py``."""

from apex_tpu_torch.serving.cache import KVCache, init_cache  # noqa: F401
from apex_tpu_torch.serving.decode import (  # noqa: F401
    make_decode_fn,
    make_prefill_fn,
)
from apex_tpu_torch.serving.health import (  # noqa: F401
    NonFiniteLogits,
    RequestOutcome,
)
from apex_tpu_torch.serving.sampling import (  # noqa: F401
    finite_rows,
    sample_tokens,
)
from apex_tpu_torch.serving.scheduler import (  # noqa: F401
    ContinuousBatchingScheduler,
    DecodeEngine,
    Request,
)

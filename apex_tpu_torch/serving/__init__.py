"""Serving: KV-cached incremental decode for the port's GPT — the dense
per-slot cache and the paged cache (a page pool with per-slot block
tables, prefix sharing, copy-on-write and preemption, bf16/fp32 or int8
pages), greedy and sampled continuous batching, bf16/fp32 or weight-only
int8 params (detected by the engines). See ``scheduler.py``."""

from apex_tpu_torch.serving.cache import (  # noqa: F401
    KVCache, PagedKVCache, audit_block_tables, init_cache,
    init_paged_cache,
)
from apex_tpu_torch.serving.decode import (  # noqa: F401
    make_copy_page_fn, make_decode_fn, make_paged_decode_fn,
    make_paged_prefill_fn, make_prefill_fn,
)
from apex_tpu_torch.serving.health import (  # noqa: F401
    NonFiniteLogits, PoolExhausted, PoolInvariantError, QuotaExhausted,
    RequestOutcome, ServingError,
)
from apex_tpu_torch.serving.paging import (  # noqa: F401
    PAGE_KEY_VERSION, SPILL_DTYPE_TAGS, PagePool, PrefixRegistry,
    QuotaLedger, SpillRecord, decode_spill_header, encode_spill_header,
    prefix_page_keys, spill_checksum,
)
from apex_tpu_torch.serving.sampling import (  # noqa: F401
    finite_rows,
    sample_tokens,
)
from apex_tpu_torch.serving.scheduler import (  # noqa: F401
    ContinuousBatchingScheduler, DecodeEngine, PagedDecodeEngine, Request,
)

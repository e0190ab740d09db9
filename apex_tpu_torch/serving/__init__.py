"""Serving: KV-cached incremental decode for the port's GPT — the dense
per-slot cache and the paged cache (a page pool with per-slot block
tables, prefix sharing, copy-on-write, preemption and a host spill tier,
bf16/fp32 or int8 pages), greedy and sampled continuous batching,
speculative decoding (n-gram, model and tree drafts), chunked prefill,
bf16/fp32 or weight-only int8 params (detected by the engines), the
tracer and metrics registry with tick-clock latency (``observe.py``),
the fault tier (``faults.py``: a deterministic ``FaultInjector``
consulted at named host-side sites; ``health.py``: the typed failure
taxonomy, quarantine, retry budgets, deadlines, backpressure and the
watchdog), and the multi-tenant front end (``tenancy.py``: weighted fair
share, page quotas, priority preemption, SLOs; ``streaming.py``:
per-token delivery), and the cross-replica tier (``transfer.py``: the
verified page handoff ``PageTransfer`` and its device-to-device tier
``PageReshard``; ``router.py``: the disaggregated prefill/decode pair
``DisaggregatedRouter`` and the N x M ``PoolRouter``), and tensor-parallel
serving (``decode.py``'s ``make_tp_*_fn`` steps on each rank's blocks of
the params and the cache, the drafter over a mesh, the mesh transfer
functions). See ``scheduler.py``."""

from apex_tpu_torch.serving.cache import (  # noqa: F401
    KVCache, PagedKVCache, audit_block_tables, cache_partition_specs,
    init_cache, init_paged_cache, paged_cache_partition_specs,
)
from apex_tpu_torch.serving.decode import (  # noqa: F401
    gather_tp_cache, make_chunk_prefill_fn, make_copy_page_fn,
    make_decode_fn, make_paged_chunk_prefill_fn, make_paged_decode_fn,
    make_paged_prefill_fn, make_paged_tree_verify_fn, make_paged_verify_fn,
    make_prefill_fn, make_tp_chunk_prefill_fn, make_tp_decode_fn,
    make_tp_paged_chunk_prefill_fn, make_tp_paged_decode_fn,
    make_tp_paged_prefill_fn, make_tp_paged_tree_verify_fn,
    make_tp_paged_verify_fn, make_tp_prefill_fn, make_tp_tree_verify_fn,
    make_tp_verify_fn, make_tree_verify_fn, make_verify_fn, shard_tp_cache,
    shard_tp_params,
)
from apex_tpu_torch.serving.draft import ngram_draft, tree_arrays  # noqa: F401
from apex_tpu_torch.serving.draft_model import DraftModel  # noqa: F401
from apex_tpu_torch.serving.faults import (  # noqa: F401
    SITES, FaultInjector, InjectedFault, fault_draw,
)
from apex_tpu_torch.serving.health import (  # noqa: F401
    FINISH_REASONS, HEALTH_STATES, AdmissionRejected, DeadlineExceeded,
    LivelockError, NonFiniteLogits, PoolExhausted, PoolInvariantError,
    PromoteFailed, QuotaExhausted, ReplicaHealth, ReplicaUnavailable,
    RequestOutcome, ReshardFailed, RetryBudgetExhausted, ServingError,
    ServingStats, SloViolation, SpillFailed, StreamFailed,
    TransferCorrupt, TransferFailed,
)
from apex_tpu_torch.serving.observe import (  # noqa: F401
    FlightRecorder, MetricsRegistry, TraceEvent, Tracer,
)
from apex_tpu_torch.serving.paging import (  # noqa: F401
    PAGE_KEY_VERSION, SPILL_DTYPE_TAGS, PagePool, PrefixRegistry,
    QuotaLedger, SpillRecord, decode_spill_header, encode_spill_header,
    prefix_page_keys, spill_checksum,
)
from apex_tpu_torch.serving.router import (  # noqa: F401
    DisaggregatedRouter, PoolRouter,
)
from apex_tpu_torch.serving.sampling import (  # noqa: F401
    finite_rows, sample_token_grid, sample_tokens, speculative_accept,
    tree_speculative_accept,
)
from apex_tpu_torch.serving.scheduler import (  # noqa: F401
    ContinuousBatchingScheduler, DecodeEngine, PagedDecodeEngine, Request,
)
from apex_tpu_torch.serving.streaming import (  # noqa: F401
    StreamMux, TokenStream,
)
from apex_tpu_torch.serving.tenancy import (  # noqa: F401
    DEFAULT_TENANT, Tenant, TenancyPolicy,
)
from apex_tpu_torch.serving.transfer import (  # noqa: F401
    PageReshard, PageTransfer, make_extract_pages_fn,
    make_extract_pages_quant_fn, make_insert_pages_fn,
    make_insert_pages_quant_fn, make_reshard_extract_fn,
    make_tile_transfer_fns, transfer_checksum,
)

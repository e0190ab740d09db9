"""Request outcomes, the serving counters and the serving errors
(counterpart of the part of ``apex_tpu/serving/health.py`` the ported
slices need). :class:`ServingStats` is the counter block an engine and
its scheduler share, a view over the tracer's
:class:`~apex_tpu_torch.serving.observe.MetricsRegistry`.

This port has no quarantine or retry path: a non-finite logits row (or
an out-of-vocabulary sample) raises :class:`NonFiniteLogits` and is
never committed. The page pool raises :class:`PoolExhausted` when it
cannot cover an admission (the scheduler waits for evictions), and its
audits raise :class:`PoolInvariantError`; the tenancy ledger's books
raise :class:`QuotaExhausted`. The host spill tier's promotion check
raises :class:`PromoteFailed` (the engine drops the stale record and
re-prefills); :class:`SpillFailed` names a dropped spill. The fault
taxonomy's other classes, retry budgets, deadlines and the watchdog are
a later slice.
"""

import dataclasses
from typing import Any, Dict, Optional, Tuple

from apex_tpu_torch.serving.observe import MetricsRegistry


class ServingError(RuntimeError):
    """Base of the serving failure taxonomy. Every instance carries a
    ``payload`` dict of host-side diagnostics."""

    def __init__(self, *args):
        super().__init__(*args)
        self.payload: Dict[str, Any] = {}


class PoolExhausted(ServingError):
    """The page pool cannot cover an allocation even after LRU prefix
    eviction. Transient under load: evictions free pages and the
    scheduler retries the admission."""

    def __init__(self, msg: str, *, need: int = 0, free: int = 0,
                 cached: int = 0):
        super().__init__(msg)
        self.need = need
        self.free = free
        self.cached = cached


class NonFiniteLogits(ServingError):
    """A prefill or decode step produced NaN/Inf logits (or the sampler
    returned a token outside the vocabulary) for a slot."""


class PoolInvariantError(ServingError):
    """The page allocator's books are inconsistent (refcounts vs. free
    list vs. prefix registry vs. block tables) — raised by the runtime
    audit, ``PagePool.check_invariants``."""


class QuotaExhausted(ServingError):
    """A tenant's page quota cannot cover a request's worst-case page
    reservation; raised by :class:`~apex_tpu_torch.serving.paging.
    QuotaLedger` when a charge would exceed the quota."""

    def __init__(self, msg: str, *, tenant: str = "", need: int = 0,
                 quota: int = 0, charged: int = 0):
        super().__init__(msg)
        self.tenant = tenant
        self.need = need
        self.quota = quota
        self.charged = charged
        self.payload.update(tenant=tenant, need=need, quota=quota,
                            charged=charged)


class SpillFailed(ServingError):
    """A page spill to the host tier was dropped before the payload
    reached it. A cache-efficiency loss only: the evicted prefix leaves
    both tiers and a later admission re-prefills it."""

    def __init__(self, msg: str, *, key: str = ""):
        super().__init__(msg)
        self.key = key
        self.payload.update(key=key)


class PromoteFailed(ServingError):
    """A host-to-device page promotion failed verification: the record's
    checksum did not recompute, or its versioned header named another
    prompt chain or pool geometry. The stale record is dropped and the
    admission re-prefills the uncovered rest of the prompt, so the
    committed stream is the spill-free one."""

    def __init__(self, msg: str, *, key: str = "", pages: int = 0):
        super().__init__(msg)
        self.key = key
        self.pages = pages
        self.payload.update(key=key, pages=pages)


#: ``ServingStats`` counter fields -> help text. Order defines the
#: ``as_dict`` / Prometheus export order; each field is backed by a
#: ``serving_<field>_total`` counter in the stats' MetricsRegistry.
STAT_FIELDS = {
    "admission_rejections": "submit() refused: queue full",
    "pool_exhausted": "admissions parked waiting for pages",
    "preemptions": "slots requeued on page pressure",
    "cow_copies": "shared pages cloned before append",
    "retries": "fault-path requeues (budgeted)",
    "nan_events": "non-finite logits quarantines",
    "bad_samples": "out-of-vocab sampled tokens",
    "deadline_expired": "requests cut at deadline_ticks",
    "evictions": "healthy completions freeing a slot",
    "tokens_drafted": "speculative candidates proposed",
    "tokens_accepted": "drafted candidates that committed",
    "draft_faults": "draft_exec faults (degraded ticks)",
    "spec_ticks": "verify-step ticks (linear or tree)",
    "plain_ticks": "single-token decode ticks",
    "prefill_chunks": "chunked-prefill chunk forwards run",
    "remote_prefills": "admissions prefilled on the remote replica",
    "colocated_prefills": "admissions served colocated (fallback)",
    "transfers": "page handoffs delivered and verified",
    "transfer_pages_deduped": "handoff pages skipped: receiver held them",
    "transfer_retries": "page-handoff attempts retried",
    "transfer_corrupt": "handoff payloads quarantined on checksum",
    "transfer_failures": "handoffs abandoned (budget exhausted)",
    "reshards": "device-to-device page reshards delivered and verified",
    "reshard_retries": "reshard attempts retried over the ICI/DCN link",
    "reshard_corrupt": "reshard payloads quarantined on checksum",
    "reshard_failures": "reshards abandoned (degraded to host staging)",
    "route_fallbacks": "pool_route faults: fixed-order routing used",
    "rebalances": "decode placement moved to a sibling replica",
    "failovers": "active-replica switches (slots drained + requeued)",
    "host_spills": "pages spilled HBM->host on LRU eviction",
    "host_spill_failures": "spills dropped (fault or tier rejection)",
    "host_spill_bytes": "payload bytes spilled to the host tier",
    "host_promotes": "pages promoted host->HBM on a prefix hit",
    "host_promote_failures": "promotions abandoned (fault/verification)",
    "host_promote_bytes": "payload bytes promoted from the host tier",
    "host_promote_ticks": "tick-clock cost charged for promotions",
    "stream_batches": "per-token stream batches delivered",
    "stream_tokens": "tokens delivered through token streams",
    "stream_failures": "stream_emit faults: streams closed early",
    "quota_exhausted": "submits refused on tenant page quota",
    "quota_deferrals": "admissions deferred on tenant quota pressure",
    "chunk_deferrals": "prefill chunks deferred on fair-share overrun",
    "tenant_preemptions": "slots requeued for a higher-priority tenant",
    "slo_violations": "finished requests that broke their tenant SLO",
}


class ServingStats:
    """Degradation counters, shared by an engine and its scheduler:
    plain host-side ints.

    A *view* over a
    :class:`~apex_tpu_torch.serving.observe.MetricsRegistry`: every
    field in :data:`STAT_FIELDS` is backed by the
    ``serving_<field>_total`` counter in ``registry`` (attribute reads
    and ``+=`` writes go straight to the counter object), so the
    counter block and the Prometheus/JSON exports share storage and
    cannot drift. The engine passes its tracer's registry; a bare
    ``ServingStats()`` owns a private registry. The fields of the
    slices not ported yet (faults, transfers, tenancy, streams) stay
    0.
    """

    FIELDS = tuple(STAT_FIELDS)

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 **counts: int):
        unknown = set(counts) - set(STAT_FIELDS)
        if unknown:
            raise TypeError(f"unknown ServingStats fields: {sorted(unknown)}")
        d = self.__dict__
        d["registry"] = registry if registry is not None else MetricsRegistry()
        d["_counters"] = {
            f: d["registry"].counter(f"serving_{f}_total", help=doc)
            for f, doc in STAT_FIELDS.items()}
        for f, v in counts.items():
            d["_counters"][f].value = int(v)

    def __getattr__(self, name):
        c = self.__dict__.get("_counters", {}).get(name)
        if c is None:
            raise AttributeError(name)
        return c.value

    def __setattr__(self, name, value):
        c = self.__dict__.get("_counters", {}).get(name)
        if c is None:
            raise AttributeError(f"ServingStats has no counter {name!r}")
        c.value = int(value)

    def __eq__(self, other):
        if not isinstance(other, ServingStats):
            return NotImplemented
        return ({f: c.value for f, c in self._counters.items()} ==
                {f: c.value for f, c in other._counters.items()})

    def __repr__(self):
        inner = ", ".join(f"{f}={c.value}"
                          for f, c in self._counters.items())
        return f"ServingStats({inner})"

    @property
    def acceptance_rate(self) -> float:
        """Accepted / drafted speculative candidates (0.0 before any
        draft). The number that prices the verify step: at depth k and
        acceptance rate a, the expected tokens per parameter read is
        the expected accepted-prefix length + 1."""
        if not self.tokens_drafted:
            return 0.0
        return self.tokens_accepted / self.tokens_drafted

    def as_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {f: c.value for f, c in self._counters.items()}
        d["acceptance_rate"] = round(self.acceptance_rate, 6)
        return d


@dataclasses.dataclass(frozen=True)
class RequestOutcome:
    """How one request ended: its committed tokens and a reason
    (``eos``, ``length`` or ``cache_full``). ``ttft_ticks`` /
    ``total_ticks`` are tick-clock latencies (submit -> first token,
    submit -> finish); ``prefill_ticks`` counts the ticks that ran its
    prefill."""

    tokens: Tuple[int, ...]
    reason: str
    ttft_ticks: Optional[int] = None
    total_ticks: Optional[int] = None
    prefill_ticks: Optional[int] = None


def snapshot(obj: Any) -> Dict:
    """Best-effort plain-dict view of a stats/outcome object for error
    payloads and bench ``extra`` blocks."""
    if hasattr(obj, "as_dict"):
        return obj.as_dict()
    if dataclasses.is_dataclass(obj):
        return dataclasses.asdict(obj)
    return dict(obj)

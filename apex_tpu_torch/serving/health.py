"""Typed failure taxonomy + runtime counters for the serving engine
(counterpart of ``apex_tpu/serving/health.py``: the same host code).

Apex's signature robustness move is the dynamic loss scaler: overflow
is an EXPECTED state — detect it, skip the step, back off, keep
training. This module gives the serving stack the same discipline.
Instead of ``None`` returns and bare ``RuntimeError``\\ s, every way a
request can fail is a named exception the scheduler either *recovers
from* (retry/requeue) or *reports* (a :class:`RequestOutcome` with a
typed reason), and every degradation event increments a counter in
:class:`ServingStats` so a chaos run — or a production dashboard — can
see exactly how the engine bent instead of broke. The counters are a
view over the ``serving.observe`` :class:`MetricsRegistry`, so the
same numbers come out of the Prometheus/JSON exports.

Everything here is plain host-side Python: no torch, no device state,
no clocks.

Taxonomy (all subclass :class:`ServingError`):

==========================  ===============================================
:class:`PoolExhausted`      the page pool cannot cover an allocation even
                            after LRU prefix eviction (transient: retried
                            after evictions free pages)
:class:`NonFiniteLogits`    a decode/prefill step produced NaN/Inf logits
                            or an out-of-range sampled token; the slot is
                            quarantined and the request retried
:class:`RetryBudgetExhausted`  a request burned through its per-request
                            retry budget; it terminates with the tokens
                            committed so far
:class:`DeadlineExceeded`   a request overran its ``deadline_ticks``
                            budget (scheduler ticks, deterministic — no
                            wall clocks)
:class:`AdmissionRejected`  backpressure: the bounded admission queue is
                            full at ``submit()``
:class:`LivelockError`      the scheduler's progress watchdog fired —
                            carries the stuck request set and a pool
                            snapshot instead of spinning forever
:class:`PoolInvariantError` the runtime audit
                            (``PagePool.check_invariants``) found the
                            allocator's books inconsistent
:class:`TransferFailed`     a cross-replica page handoff exhausted its
                            per-transfer retry budget (every attempt
                            dropped at the ``page_send`` site); the
                            router falls back to colocated prefill
:class:`TransferCorrupt`    the received page payload failed checksum /
                            page-key verification — the tiles are
                            quarantined (never installed, never
                            attended) and the attempt retried
:class:`ReplicaUnavailable` a routing target is unusable: its health
                            state is ``down``, or its own page pool
                            refused the prompt — the router serves the
                            request colocated on the surviving engine
:class:`ReshardFailed`      a device-to-device page reshard exhausted
                            its retry budget (``reshard_send`` drops or
                            ``reshard_recv`` corruption); the pool
                            router degrades the handoff to the
                            host-staged ``PageTransfer`` path — a
                            subclass of :class:`TransferFailed`, so
                            single-pair callers keep their ladder
:class:`SpillFailed`        an HBM→host page spill was dropped (the
                            ``host_spill`` fault site, or a payload the
                            host tier rejected); the evicted prefix
                            leaves both tiers and a later admission
                            re-prefills it — never retried, never fatal
:class:`PromoteFailed`      a host→HBM promotion failed (fault, checksum
                            mismatch, wrong-chain header, geometry
                            drift); the stale host-tier entry is dropped
                            and the admission degrades to re-prefilling
                            the uncovered remainder of the prompt
:class:`StreamFailed`       a per-token stream delivery batch was dropped
                            at the ``stream_emit`` fault site; the stream
                            closes and its delivered tokens remain a
                            STRICT PREFIX of the committed outcome — the
                            request itself is never perturbed
:class:`QuotaExhausted`     a tenant's page quota cannot cover a request's
                            worst-case page reservation — raised at
                            ``submit()`` (the tenancy analogue of
                            :class:`AdmissionRejected` backpressure)
:class:`SloViolation`       a finished request broke its tenant's declared
                            TTFT/ITL tick bound; attached to
                            ``RequestOutcome.slo`` as a diagnostic (the
                            outcome itself stays healthy)
==========================  ===============================================

The disaggregated tier adds one piece of host-side *state* here too:
:class:`ReplicaHealth`, the per-replica probe-driven
healthy → degraded → down ladder the
:class:`~apex_tpu_torch.serving.router.DisaggregatedRouter` consults before
routing a prefill to the remote replica (and to decide mid-stream
failover when the ACTIVE replica goes down). Like the counters it is
plain Python host state. The port's router is a later slice; the
ladder is here whole.
"""

import dataclasses
from typing import Any, Dict, Optional, Tuple

from apex_tpu_torch.serving.observe import MetricsRegistry

#: ``RequestOutcome.reason`` values — the full set of ways a request
#: terminates. Healthy: ``eos`` / ``length`` / ``cache_full``; degraded
#: (``error`` carries the typed exception): ``retry_budget`` /
#: ``deadline``.
FINISH_REASONS = ("eos", "length", "cache_full", "retry_budget",
                  "deadline")


class ServingError(RuntimeError):
    """Base of the serving failure taxonomy. Every instance carries a
    ``payload`` dict of host-side diagnostics; when tracing is enabled
    the scheduler attaches the flight-recorder ring under
    ``payload["flight"]`` (``serving.observe``), so the error ships its
    own last-N-events post-mortem."""

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
    """A decode/prefill step produced NaN/Inf logits (or the sampler
    returned a token outside the vocabulary) for a slot. The slot is
    quarantined: freed, its request requeued at the front — the retry
    re-prefills from committed tokens, so the recovered stream is
    bit-identical to the fault-free one."""


class RetryBudgetExhausted(ServingError):
    """A request consumed its whole retry budget; it terminates with a
    ``retry_budget`` outcome carrying the tokens committed so far."""

    def __init__(self, msg: str, *, request_id: int = -1,
                 retries: int = 0):
        super().__init__(msg)
        self.request_id = request_id
        self.retries = retries


class DeadlineExceeded(ServingError):
    """A request overran its ``deadline_ticks`` budget. Deadlines are
    measured in scheduler ticks since submission — deterministic, so
    chaos runs replay bit-for-bit (a wall-clock deadline would not)."""


class AdmissionRejected(ServingError):
    """Backpressure: ``submit()`` refused a request because the bounded
    admission queue is full. The caller sheds load instead of growing
    an unbounded queue."""


class LivelockError(ServingError):
    """The scheduler made no progress (no token, no completion, no
    retry consumed) for ``watchdog_limit`` consecutive ticks. Carries
    the stuck request set and a pool snapshot — the diagnostic a
    copy-on-write livelock needs, raised instead of spinning."""

    def __init__(self, msg: str, *, stuck: Optional[Dict] = None,
                 pool: Optional[Dict] = None):
        super().__init__(msg)
        self.stuck = stuck or {}
        self.pool = pool or {}
        self.payload.update(stuck=self.stuck, pool=self.pool)


class PoolInvariantError(ServingError):
    """The page allocator's books are inconsistent (refcounts vs. free
    list vs. prefix registry vs. block tables) — raised by the runtime
    audit, ``PagePool.check_invariants``."""


class TransferFailed(ServingError):
    """A cross-replica page handoff exhausted its per-transfer retry
    budget (every attempt lost at the ``page_send`` site). Carries the
    attempt count and the page batch size; the router catches it and
    serves the admission colocated — the request never sees it."""

    def __init__(self, msg: str, *, attempts: int = 0, pages: int = 0):
        super().__init__(msg)
        self.attempts = attempts
        self.pages = pages
        self.payload.update(attempts=attempts, pages=pages)


class TransferCorrupt(ServingError):
    """A received page payload failed verification: the transfer
    checksum (sha256 over the staged K/V tile bytes + the chained
    prefix page key) did not match what the sender computed. The tiles
    are QUARANTINED — discarded without ever being installed into the
    receiving pool, so corrupt KV rows are never attended. Raised out
    of the transfer only when corruption also exhausted the retry
    budget; the router then falls back colocated."""

    def __init__(self, msg: str, *, attempts: int = 0, pages: int = 0):
        super().__init__(msg)
        self.attempts = attempts
        self.pages = pages
        self.payload.update(attempts=attempts, pages=pages)


class ReshardFailed(TransferFailed):
    """A device-to-device page reshard (``serving.transfer.PageReshard``,
    the spec-to-spec ICI/DCN tier) exhausted its per-handoff retry
    budget — every attempt dropped at ``reshard_send`` or quarantined at
    the ``reshard_recv`` checksum (``corrupt`` tells which ended the
    run). The pool router catches it and re-ships the SAME pages over
    the host-staged ``PageTransfer`` channel: the reshard tier may only
    lose performance, never a request. Subclasses
    :class:`TransferFailed` so any caller handling the single-pair
    taxonomy keeps its ladder unchanged."""

    def __init__(self, msg: str, *, attempts: int = 0, pages: int = 0,
                 corrupt: bool = False):
        super().__init__(msg, attempts=attempts, pages=pages)
        self.corrupt = corrupt
        self.payload.update(corrupt=corrupt)


class ReplicaUnavailable(ServingError):
    """A routing target cannot serve: its :class:`ReplicaHealth` is
    ``down``, or its own page pool refused the prompt's pages. The
    router catches it and degrades to colocated prefill+decode on the
    surviving engine — a dead replica yields this typed diagnostic,
    never a hang."""

    def __init__(self, msg: str, *, replica: str = ""):
        super().__init__(msg)
        self.replica = replica
        self.payload.update(replica=replica)


class SpillFailed(ServingError):
    """An HBM→host page spill was dropped before the payload reached
    the host tier (the ``host_spill`` fault site fired, or the
    :class:`~apex_tpu_torch.serving.paging.PrefixRegistry` rejected the
    record). Purely a cache-efficiency loss: the evicted prefix simply
    leaves both tiers and a later admission re-prefills it — the spill
    path never retries and never fails a request."""

    def __init__(self, msg: str, *, key: str = ""):
        super().__init__(msg)
        self.key = key
        self.payload.update(key=key)


class PromoteFailed(ServingError):
    """A host→HBM page promotion failed verification or faulted: the
    record's checksum did not recompute, its versioned header named a
    different prompt chain or pool geometry, or the ``host_promote``
    fault site fired. The stale host-tier entry is dropped (checksum /
    header mismatches only) and the admission DEGRADES GRACEFULLY —
    pages promoted so far are kept, the uncovered remainder of the
    prompt re-prefills, and the committed stream stays bit-identical to
    the spill-disabled scheduler."""

    def __init__(self, msg: str, *, key: str = "", pages: int = 0):
        super().__init__(msg)
        self.key = key
        self.pages = pages
        self.payload.update(key=key, pages=pages)


class StreamFailed(ServingError):
    """A per-token stream delivery batch was dropped: the
    ``stream_emit`` fault site fired while the
    :class:`~apex_tpu_torch.serving.streaming.StreamMux` was flushing a
    request's staged tokens. The batch is discarded and the stream
    CLOSES — its ``delivered`` tokens stay a strict prefix of the
    committed ``RequestOutcome.tokens`` — while the request itself
    keeps decoding untouched (stream delivery is host-side fan-out,
    never part of the committed-stream contract)."""

    def __init__(self, msg: str, *, request_id: int = -1,
                 delivered: int = 0, dropped: int = 0):
        super().__init__(msg)
        self.request_id = request_id
        self.delivered = delivered
        self.dropped = dropped
        self.payload.update(request_id=request_id, delivered=delivered,
                            dropped=dropped)


class QuotaExhausted(ServingError):
    """A tenant's page quota cannot cover a request's worst-case page
    reservation (prompt + ``max_new_tokens`` + speculative headroom,
    priced by the paged engine's geometry). Raised by ``submit()`` when
    the request could NEVER fit its tenant's quota — the tenancy
    analogue of :class:`AdmissionRejected` backpressure. Transient
    quota pressure (the tenant's other live requests hold the pages)
    never raises: admission simply defers the request until a
    completion credits the reservation back."""

    def __init__(self, msg: str, *, tenant: str = "", need: int = 0,
                 quota: int = 0, charged: int = 0):
        super().__init__(msg)
        self.tenant = tenant
        self.need = need
        self.quota = quota
        self.charged = charged
        self.payload.update(tenant=tenant, need=need, quota=quota,
                            charged=charged)


class SloViolation(ServingError):
    """A finished request broke its tenant's declared service-level
    objective: TTFT or worst-case inter-token latency exceeded the
    tenant's tick bound. Never raised — the scheduler stamps it into
    ``RequestOutcome.slo`` as a typed diagnostic (the outcome's
    ``error``/``ok`` contract is untouched: an SLO miss is a latency
    fact, not a failure) and bumps the ``slo_violations`` counter."""

    def __init__(self, msg: str, *, tenant: str = "", metric: str = "",
                 observed: int = 0, bound: int = 0):
        super().__init__(msg)
        self.tenant = tenant
        self.metric = metric
        self.observed = observed
        self.bound = bound
        self.payload.update(tenant=tenant, metric=metric,
                            observed=observed, bound=bound)


#: ``ReplicaHealth`` states, worst first. The index doubles as the
#: ``serving_replica_health`` gauge value (0 = down .. 2 = healthy) so
#: dashboards can alert on ``< 2`` without string labels.
HEALTH_STATES = ("down", "degraded", "healthy")


class ReplicaHealth:
    """Per-replica probe-driven health ladder: ``healthy`` → ``degraded``
    → ``down``, one rung per failed observation, with hysteresis on the
    way back up (``recover_after`` CONSECUTIVE successes per rung — a
    flapping replica cannot oscillate straight back into the routing
    set). Observations come from two places, both deterministic: the
    router's per-tick ``replica_health`` fault-site probes, and real
    transfer/prefill outcomes against the replica (a failed handoff
    attempt is evidence exactly like a failed probe).

    ``routable`` gates routing: ``down`` replicas receive no prefills
    and trigger failover when they back the active slots. The state is
    exported as the ``serving_replica_health`` gauge (per-replica
    label) on every transition and probe.

    Host state, as the counters are.
    """

    def __init__(self, name: str,
                 registry: Optional[MetricsRegistry] = None,
                 recover_after: int = 2):
        if recover_after < 1:
            raise ValueError(
                f"recover_after must be >= 1, got {recover_after}")
        self.name = name
        self.state = "healthy"
        self.recover_after = recover_after
        self._ok_streak = 0
        self.transitions = 0
        self._gauge = None if registry is None else registry.gauge(
            "serving_replica_health",
            help="replica health ladder (2 healthy / 1 degraded / "
                 "0 down)", labels={"replica": name})
        self._export()

    def _export(self) -> None:
        if self._gauge is not None:
            self._gauge.set(HEALTH_STATES.index(self.state))

    @property
    def routable(self) -> bool:
        """May receive new work (``down`` replicas may not; ``degraded``
        ones still serve — they are one failure from the exit, not out)."""
        return self.state != "down"

    def probe(self, ok: bool) -> str:
        """Fold one observation (probe result, transfer outcome, remote
        prefill outcome) into the ladder and return the new state."""
        prev = self.state
        if ok:
            self._ok_streak += 1
            if self._ok_streak >= self.recover_after \
                    and self.state != "healthy":
                self.state = ("degraded" if self.state == "down"
                              else "healthy")
                self._ok_streak = 0
        else:
            self._ok_streak = 0
            if self.state == "healthy":
                self.state = "degraded"
            elif self.state == "degraded":
                self.state = "down"
        if self.state != prev:
            self.transitions += 1
            self._export()
        elif self._gauge is not None and self._gauge.value \
                != HEALTH_STATES.index(self.state):
            self._export()
        return self.state

    def __repr__(self):
        return (f"ReplicaHealth({self.name!r}, state={self.state!r}, "
                f"ok_streak={self._ok_streak})")


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
    """Degradation counters, shared by an engine and its scheduler.
    Pure host-side ints.

    A *view* over a
    :class:`~apex_tpu_torch.serving.observe.MetricsRegistry`: every
    field in :data:`STAT_FIELDS` is backed by the
    ``serving_<field>_total`` counter in ``registry`` (attribute reads
    and ``+=`` writes go straight to the counter object), so the counter
    block and the Prometheus/JSON exports share storage and cannot
    drift. The
    engine passes its tracer's registry; a bare ``ServingStats()``
    still works and owns a private registry.
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
    """How one request ended: its committed token stream plus a typed
    reason (one of :data:`FINISH_REASONS`). Degraded terminations carry
    the :class:`ServingError` that ended them in ``error``; for those,
    ``tokens`` is a prefix of the fault-free stream (quarantine never
    commits a corrupt token).

    ``ttft_ticks`` / ``total_ticks`` are tick-clock latencies stamped
    by the scheduler's tracer bookkeeping: submit -> first committed
    token, and submit -> termination. ``ttft_ticks`` is ``None`` when
    the request died before emitting anything. ``prefill_ticks`` counts
    the ticks that ran prefill work for the request (1 on the
    monolithic path; the number of chunk-carrying ticks, across
    retries, when chunked prefill is on) — ``None`` when the request
    never reached prefill.

    ``tenant_id`` names the tenant the request was submitted under
    (``"default"`` when tenancy is off — byte-compatible with the
    untenanted scheduler). ``slo`` carries a typed
    :class:`SloViolation` when the request finished outside its
    tenant's declared TTFT/ITL bounds; it is a latency diagnostic,
    not a failure — ``ok`` looks only at ``error``."""

    tokens: Tuple[int, ...]
    reason: str
    error: Optional[ServingError] = None
    retries: int = 0
    ttft_ticks: Optional[int] = None
    total_ticks: Optional[int] = None
    prefill_ticks: Optional[int] = None
    tenant_id: str = "default"
    slo: Optional[ServingError] = None

    @property
    def ok(self) -> bool:
        return self.error is None


def snapshot(obj: Any) -> Dict:
    """Best-effort plain-dict view of a stats/outcome object for error
    payloads and bench ``extra`` blocks."""
    if hasattr(obj, "as_dict"):
        return obj.as_dict()
    if dataclasses.is_dataclass(obj):
        return dataclasses.asdict(obj)
    return dict(obj)

"""Deterministic fault injection for the serving engine (counterpart
of ``apex_tpu/serving/faults.py``: the same host code, so a schedule
draws the same faults on either package).

Chaos testing is only useful when a failing run can be replayed
bit-for-bit. The :class:`FaultInjector` therefore owns NO random state:
whether site ``s`` faults on its ``i``-th call is a pure function of
``(seed, s, i)`` — a sha256 hash mapped to a uniform draw — so a fault
schedule is fully determined by the seed and the (deterministic) order
in which the scheduler visits the sites. Re-running the same request
stream with the same seed replays the exact same faults, and a single
``(site, index)`` can be pinned via ``schedule=`` for surgical
regression tests.

Sites (consulted through host-side hooks — the device steps
themselves are never perturbed; a fault is applied to their outputs or
replaces a call):

=================  ======================================================
``pool_alloc``     ``PagePool.alloc`` reports exhaustion (returns None)
                   without sweeping the LRU registry — a transient
                   allocation refusal
``cow_clone``      the copy-on-write clone allocation in
                   ``PagedDecodeEngine.prepare_decode`` fails — the slot
                   is preempted and requeued
``prefill_exec``   ``prefill`` raises :class:`InjectedFault` before
                   touching the cache (page references are rolled back
                   first) — a simulated transient device failure
``chunk_prefill_exec``
                   one prompt CHUNK raises :class:`InjectedFault`
                   before touching the cache — a mid-prefill device
                   failure. The scheduler frees the slot (releasing
                   every held page), charges the retry budget, and
                   requeues the request at the head; the retried
                   prefill restarts from the prompt start, so the
                   recovered stream is bit-identical to golden
``decode_exec``    one slot's decode logits row is overwritten with NaN
                   AFTER the device step — exercises the scheduler's
                   always-on non-finite quarantine path
``sample``         one slot's sampled token is replaced with an
                   out-of-vocabulary id — exercises token validation
``draft_exec``     drafting fails. N-gram engines draw once per slot and
                   degrade that slot to an empty draft (plain decode
                   pace) for the tick. Engines with a model drafter
                   degrade down a LADDER: the first fired draw falls
                   back from the model draft to the n-gram draft for the
                   whole batch, and a second fired draw on the SAME tick
                   raises :class:`InjectedFault` — the scheduler empties
                   every draft (plain tick). No rung charges retry
                   budget; the stream stays bit-identical throughout
``page_send``      one cross-replica page-handoff attempt fails before
                   any bytes move (``serving.transfer.PageTransfer``) —
                   a dropped/late send. The transfer retries under its
                   per-transfer budget; exhaustion raises
                   :class:`~apex_tpu_torch.serving.health.TransferFailed` and
                   the router falls back to colocated prefill
``page_recv``      the received page payload is corrupted in flight
                   (one staged byte flipped, payload-selected). The
                   receiver's checksum verification catches it, the
                   corrupt tiles are QUARANTINED (never installed, never
                   attended), and the attempt counts against the same
                   retry budget as ``page_send``
``replica_health`` one replica health probe fails
                   (``serving.router.DisaggregatedRouter`` draws once
                   per replica per tick, in fixed replica order).
                   Consecutive failures walk the replica down the
                   healthy -> degraded -> down ladder
                   (``serving.health.ReplicaHealth``); a down remote
                   stops receiving prefills, a down ACTIVE replica
                   triggers mid-stream failover
``host_spill``     one HBM->host page spill is dropped before any bytes
                   move (``PagedDecodeEngine._spill_page``, typed
                   :class:`~apex_tpu_torch.serving.health.SpillFailed`). The
                   evicted prefix simply leaves both tiers — a later
                   admission re-prefills it; nothing is retried and the
                   committed streams are untouched
``host_promote``   one host->HBM promotion fails mid-chain
                   (``PagedDecodeEngine._promote_chain``, typed
                   :class:`~apex_tpu_torch.serving.health.PromoteFailed`).
                   The admission degrades gracefully: pages promoted so
                   far are kept, the remainder of the prompt is
                   re-prefilled — the recovered stream is bit-identical
                   to golden
``reshard_send``   one device-to-device reshard attempt fails before
                   any bytes move (``serving.transfer.PageReshard``) —
                   a dropped spec-to-spec send over the ICI/DCN link.
                   Retried under the reshard's own budget; exhaustion
                   raises :class:`~apex_tpu_torch.serving.health.ReshardFailed`
                   and the pool router degrades the handoff to the
                   HOST-STAGED ``PageTransfer`` path (which draws
                   ``page_send``/``page_recv`` as usual)
``reshard_recv``   the resharded page payload is corrupted in flight
                   (one staged byte flipped, payload-selected) — the
                   chain-key-bound checksum catches it, the tiles are
                   QUARANTINED, and the attempt counts against the
                   reshard budget exactly like ``reshard_send``
``pool_route``     one load-based routing decision is degraded
                   (``serving.router.PoolRouter`` draws once per
                   remote-prefill admission): the load snapshot is
                   treated as unavailable and the router falls back to
                   the FIRST routable prefill replica in fixed pool
                   order — a routing-policy fault, never a stream
                   fault (placement cannot move committed tokens)
``stream_emit``    one per-token stream delivery batch is dropped
                   (``serving.streaming.StreamMux`` draws once per
                   request with staged tokens at each end-of-tick
                   flush, in sorted request order, typed
                   :class:`~apex_tpu_torch.serving.health.StreamFailed`).
                   The batch is discarded and the stream CLOSES — the
                   delivered tokens stay a strict prefix of the
                   committed outcome; the request itself keeps
                   decoding, so committed streams are untouched
=================  ======================================================

This module is host state (counters and schedules). The sites of the
cross-replica tier (``page_send``, ``page_recv``, ``replica_health``,
``reshard_send``, ``reshard_recv``, ``pool_route``) keep their names and
contracts here; the port's transfer and router modules that consult them
are later slices.
"""

import hashlib
from typing import Dict, Iterable, Mapping, Optional, Tuple

#: The named fault sites, in the order the docs list them.
SITES = ("pool_alloc", "cow_clone", "prefill_exec", "chunk_prefill_exec",
         "decode_exec", "sample", "draft_exec", "page_send", "page_recv",
         "replica_health", "host_spill", "host_promote", "reshard_send",
         "reshard_recv", "pool_route", "stream_emit")

#: Per-site contract: ``site -> (typed degrade error | None,
#: CI chaos-matrix sweep env | None)``. The error is the
#: ``ServingError`` subclass (or :class:`InjectedFault`) the site's
#: degrade path raises when its budget/ladder is exhausted — ``None``
#: for policy-only faults that alter a decision instead of raising
#: (``pool_route`` falls back to fixed-order routing). The sweep env
#: is the seed variable a CI chaos-matrix leg fans for the site's
#: family — ``None`` for sites exercised by the default deterministic
#: schedules in every leg. apxlint APX802 cross-checks this table
#: against the consultation call sites, the taxonomy, the chaos
#: tests, and ``ci.yml`` in both directions; the port keeps the table
#: as it is, in lockstep with :data:`SITES` and the table above.
SITE_CONTRACTS = {
    "pool_alloc": ("PoolExhausted", None),
    "cow_clone": ("PoolExhausted", None),
    "prefill_exec": ("InjectedFault", None),
    "chunk_prefill_exec": ("InjectedFault", None),
    "decode_exec": ("NonFiniteLogits", None),
    "sample": ("NonFiniteLogits", None),
    "draft_exec": ("InjectedFault", None),
    "page_send": ("TransferFailed", "APEX_CHAOS_TRANSFER_SEED"),
    "page_recv": ("TransferCorrupt", "APEX_CHAOS_TRANSFER_SEED"),
    "replica_health": ("ReplicaUnavailable", "APEX_CHAOS_TRANSFER_SEED"),
    "host_spill": ("SpillFailed", "APEX_CHAOS_SPILL_SEED"),
    "host_promote": ("PromoteFailed", "APEX_CHAOS_SPILL_SEED"),
    "reshard_send": ("ReshardFailed", "APEX_CHAOS_POOL_SEED"),
    "reshard_recv": ("ReshardFailed", "APEX_CHAOS_POOL_SEED"),
    "pool_route": (None, "APEX_CHAOS_POOL_SEED"),
    "stream_emit": ("StreamFailed", "APEX_CHAOS_TENANT_SEED"),
}


class InjectedFault(RuntimeError):
    """A simulated transient failure (site ``prefill_exec``). The
    scheduler treats it exactly like a real device fault: charge the
    retry budget, back off, try again."""

    def __init__(self, site: str, index: int):
        super().__init__(f"injected fault at {site}[{index}]")
        self.site = site
        self.index = index


def fault_draw(seed: int, site: str, index: int) -> Tuple[float, int]:
    """The pure schedule function: ``(u01, payload)`` for call
    ``index`` at ``site`` under ``seed``. ``u01`` decides whether the
    call faults (compare against the site's rate); ``payload`` is a
    deterministic uint32 the caller may use to pick a victim slot."""
    h = hashlib.sha256(f"{seed}:{site}:{index}".encode()).digest()
    u01 = int.from_bytes(h[:8], "big") / 2.0**64
    return u01, int.from_bytes(h[8:12], "big")


class FaultInjector:
    """Seedable per-site fault schedule (see module doc). With neither
    ``rates`` nor ``schedule`` the injector is inert — the default
    every engine carries, so production paths pay one dict lookup and
    an integer increment per site visit.

    ``rates`` maps site -> fault probability in [0, 1] (evaluated
    against the pure hash draw, NOT a stateful RNG). ``schedule`` maps
    site -> iterable of call indices that fault unconditionally —
    the single-fault chaos tests pin exact (site, index) pairs with it.
    """

    def __init__(self, seed: int = 0,
                 rates: Optional[Mapping[str, float]] = None,
                 schedule: Optional[Mapping[str, Iterable[int]]] = None):
        for name, table in (("rates", rates), ("schedule", schedule)):
            unknown = set(table or ()) - set(SITES)
            if unknown:
                raise ValueError(
                    f"{name} names unknown fault sites {sorted(unknown)}"
                    f"; sites are {SITES}")
        self.seed = seed
        self.rates: Dict[str, float] = dict(rates or {})
        self.schedule: Dict[str, frozenset] = {
            site: frozenset(int(i) for i in ixs)
            for site, ixs in (schedule or {}).items()}
        self._calls: Dict[str, int] = {s: 0 for s in SITES}
        self._fired: Dict[str, int] = {s: 0 for s in SITES}

    @property
    def armed(self) -> bool:
        """True when any site can ever fault."""
        return bool(self.rates or self.schedule)

    def draw(self, site: str) -> Tuple[bool, int]:
        """Advance ``site``'s call counter and return ``(fired,
        payload)``. Pure replay: the outcome depends only on (seed,
        site, call index)."""
        index = self._calls[site]  # KeyError on unknown site is wanted
        self._calls[site] = index + 1
        if not self.armed:
            return False, 0
        u01, payload = fault_draw(self.seed, site, index)
        fired = (index in self.schedule.get(site, ())
                 or u01 < self.rates.get(site, 0.0))
        if fired:
            self._fired[site] += 1
        return fired, payload

    def fire(self, site: str) -> bool:
        """``draw`` for callers that only need the fault bit."""
        return self.draw(site)[0]

    def calls(self, site: str) -> int:
        """How many times ``site`` has been consulted."""
        return self._calls[site]

    @property
    def counts(self) -> Dict[str, int]:
        """Faults actually fired, per site."""
        return dict(self._fired)

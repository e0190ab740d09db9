"""Multi-tenant admission policy: weighted fair share, page quotas,
priority preemption and per-tenant SLOs for the serving front-end
(counterpart of ``apex_tpu/serving/tenancy.py``: the same host code).

The scheduler's untenanted admission is FIFO + EDF chunk interleaving:
fair across requests, blind to who submitted them. This
module adds the *who*: a :class:`Tenant` config per traffic class and
a :class:`TenancyPolicy` the scheduler consults at three points —

- **selection** — which queued request to admit next. Stride
  scheduling over the tick token budget: every token charged to a
  tenant advances its virtual time by ``1 / weight``
  (:meth:`TenancyPolicy.charge_tokens`), and selection prefers
  ``(quota-chargeable, priority desc, vtime asc, tenant id, FIFO)`` —
  so over a backlogged interval each tenant's committed-token share
  converges to its declared weight ratio, heavier tenants advancing
  their vtime more slowly per token. An idle tenant's vtime is
  clamped forward to the busy floor when new work arrives for it
  (:meth:`note_enqueued`), so sleeping never banks credit — while a
  BACKLOGGED tenant (queued or resident work outstanding) keeps its
  earned deficit across request boundaries.
- **quota** — whether the candidate's tenant can reserve its
  worst-case page need. Reservations live in a
  :class:`~apex_tpu_torch.serving.paging.QuotaLedger` charged once per
  request at first admission and credited once at finish; transient
  pressure defers admission (the selection key sorts unchargeable
  candidates last), a request that could NEVER fit raises typed
  :class:`~apex_tpu_torch.serving.health.QuotaExhausted` at ``submit()``.
- **preemption** — whether a strictly-higher-priority waiting tenant
  may requeue a resident lower-priority slot (the scheduler's
  preemption-by-requeue resume path — the same ladder pool pressure
  uses, so recovered streams stay bit-identical).

The policy reorders WHEN work happens, never WHAT commits: sampling
keys depend only on ``(seed, n_generated)``, so committed streams are
integer-identical to the untenanted scheduler.

Host state: vtimes, ledgers and reservation maps.
"""

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

from apex_tpu_torch.serving.health import SloViolation
from apex_tpu_torch.serving.paging import QuotaLedger

#: The tenant every untenanted ``Request`` lands in. A bare
#: ``TenancyPolicy([])`` still defines it (weight 1, no quota,
#: priority 0, no SLOs), so enabling tenancy without classifying
#: traffic changes nothing.
DEFAULT_TENANT = "default"


@dataclasses.dataclass(frozen=True)
class Tenant:
    """One traffic class. ``weight`` is the fair-share ratio (tokens
    per tick converge to ``weight / sum(weights)`` among backlogged
    tenants); ``page_quota`` caps the worst-case KV pages its live
    requests may reserve (``None`` = unlimited, dense engines ignore
    it); ``priority`` rungs gate preemption — a strictly higher rung
    may requeue a resident lower rung; the ``*_slo_ticks`` bounds are
    checked at finish and stamp a typed
    :class:`~apex_tpu_torch.serving.health.SloViolation` into
    ``RequestOutcome.slo`` when broken."""

    name: str
    weight: float = 1.0
    page_quota: Optional[int] = None
    priority: int = 0
    ttft_slo_ticks: Optional[int] = None
    itl_slo_ticks: Optional[int] = None

    def __post_init__(self):
        if not self.name:
            raise ValueError("tenant name must be non-empty")
        if not self.weight > 0.0:
            raise ValueError(
                f"tenant {self.name!r} weight must be > 0, got "
                f"{self.weight}")
        for field in ("page_quota", "ttft_slo_ticks", "itl_slo_ticks"):
            v = getattr(self, field)
            if v is not None and v < 1:
                raise ValueError(
                    f"tenant {self.name!r} {field} must be >= 1 or "
                    f"None, got {v}")


class TenancyPolicy:
    """The scheduler-facing tenancy state machine (see module doc).
    Construct with the non-default :class:`Tenant` configs; the
    :data:`DEFAULT_TENANT` is added automatically unless declared."""

    def __init__(self, tenants: Sequence[Tenant] = ()):
        self.tenants: Dict[str, Tenant] = {}
        for t in tenants:
            if t.name in self.tenants:
                raise ValueError(f"duplicate tenant {t.name!r}")
            self.tenants[t.name] = t
        if DEFAULT_TENANT not in self.tenants:
            self.tenants[DEFAULT_TENANT] = Tenant(DEFAULT_TENANT)
        self.ledger = QuotaLedger(
            {name: self.tenants[name].page_quota
             for name in sorted(self.tenants)})
        self._vtime: Dict[str, float] = {
            name: 0.0 for name in sorted(self.tenants)}
        self._tokens: Dict[str, int] = {
            name: 0 for name in sorted(self.tenants)}
        # request id -> (tenant, reserved pages): one charge at first
        # admission, one credit at finish — preempt/requeue/retry in
        # between never touch the books (leak-free by construction)
        self._reserved: Dict[int, Tuple[str, int]] = {}
        # outstanding work per tenant (queued + resident requests):
        # one increment at submit, one decrement at finish. A tenant
        # with live work is BACKLOGGED — its vtime deficit is its
        # fair-share claim and must survive request boundaries; the
        # idle clamp fires only on the 0 -> 1 transition.
        self._live: Dict[str, int] = {
            name: 0 for name in sorted(self.tenants)}

    def has(self, tenant: str) -> bool:
        return tenant in self.tenants

    @property
    def needs_quota(self) -> bool:
        """True when any tenant declares a page quota — the scheduler
        requires a paged engine in that case (quotas price KV pages)."""
        for name in sorted(self.tenants):
            if self.tenants[name].page_quota is not None:
                return True
        return False

    def priority(self, tenant: str) -> int:
        return self.tenants[tenant].priority

    def vtime(self, tenant: str) -> float:
        return self._vtime[tenant]

    def tokens(self, tenant: str) -> int:
        return self._tokens[tenant]

    # -- fair share -------------------------------------------------------

    def charge_tokens(self, tenant: str, n: int) -> None:
        """Advance the tenant's virtual time by ``n / weight`` — called
        for every committed token and every prefill-chunk token, so the
        stride clock prices ALL forward work, not just decode."""
        self._vtime[tenant] += n / self.tenants[tenant].weight
        self._tokens[tenant] += n

    def selection_key(self, tenant: str, chargeable: bool) -> Tuple:
        """Admission-selection sort key, lower is better: chargeable
        candidates first, then priority rung (high first), then
        fair-share vtime (low first — the tenant furthest behind its
        share), then the tenant id as a deterministic tiebreak. The
        scheduler appends queue position for FIFO within a tenant."""
        return (0 if chargeable else 1,
                -self.tenants[tenant].priority,
                self._vtime[tenant],
                tenant)

    # -- quota reservations -----------------------------------------------

    def fits_quota(self, tenant: str, need: int) -> bool:
        """Whether ``need`` pages could EVER fit the tenant's quota
        (the ``submit()`` fail-fast — ignores current reservations)."""
        q = self.tenants[tenant].page_quota
        return q is None or need <= q

    def can_admit(self, request_id: int, tenant: str, need: int) -> bool:
        """Whether admitting the request now stays within quota. A
        request that already holds its reservation (preempted, being
        re-admitted) is always admissible — its pages are pre-paid."""
        if request_id in self._reserved:
            return True
        return self.ledger.can_charge(tenant, need)

    def charge_admission(self, request_id: int, tenant: str,
                         need: int) -> bool:
        """Reserve ``need`` pages for the request (idempotent per id).
        Returns False when quota pressure defers the admission."""
        if request_id in self._reserved:
            return True
        if not self.ledger.can_charge(tenant, need):
            return False
        self.ledger.charge(tenant, need)
        self._reserved[request_id] = (tenant, need)
        return True

    def note_enqueued(self, tenant: str) -> None:
        """Record an arriving request. On the idle -> backlogged
        transition (the tenant had NO outstanding work — queued or
        resident), clamp its vtime forward to the busy floor (the
        minimum vtime among backlogged tenants) so an idle interval
        never banks fair-share credit. A tenant that stayed
        backlogged is left alone: its vtime deficit IS its earned
        fair-share claim, and clamping it at every request boundary
        would collapse stride scheduling into round-robin."""
        if self._live[tenant] == 0:
            floor = None
            for name in sorted(self._live):
                if name != tenant and self._live[name] > 0:
                    v = self._vtime[name]
                    if floor is None or v < floor:
                        floor = v
            if floor is not None and self._vtime[tenant] < floor:
                self._vtime[tenant] = floor
        self._live[tenant] += 1

    def note_finished(self, tenant: str) -> None:
        """Record a request leaving the system (finish — the same
        single exit point :meth:`credit` rides)."""
        if self._live[tenant] < 1:
            raise ValueError(
                f"tenant {tenant!r}: note_finished without a matching "
                "note_enqueued (live-count underflow)")
        self._live[tenant] -= 1

    def credit(self, request_id: int) -> None:
        """Release the request's reservation (called once, at finish —
        the single exit point every request passes through)."""
        row = self._reserved.pop(request_id, None)
        if row is not None:
            tenant, need = row
            self.ledger.credit(tenant, need)

    def charged_total(self) -> int:
        """Pages reserved across all tenants — 0 once the scheduler
        drains (the leak-free check)."""
        total = 0
        for rid in sorted(self._reserved):
            total += self._reserved[rid][1]
        return total

    # -- SLOs -------------------------------------------------------------

    def slo_check(self, tenant: str, ttft_ticks: Optional[int],
                  max_itl_ticks: Optional[int]) -> Optional[SloViolation]:
        """Evaluate a finished request against its tenant's declared
        bounds; returns the typed violation (worst metric first: TTFT
        before ITL) or None."""
        cfg = self.tenants[tenant]
        if (cfg.ttft_slo_ticks is not None and ttft_ticks is not None
                and ttft_ticks > cfg.ttft_slo_ticks):
            return SloViolation(
                f"tenant {tenant!r}: TTFT {ttft_ticks} ticks over the "
                f"{cfg.ttft_slo_ticks}-tick bound",
                tenant=tenant, metric="ttft", observed=ttft_ticks,
                bound=cfg.ttft_slo_ticks)
        if (cfg.itl_slo_ticks is not None and max_itl_ticks
                and max_itl_ticks > cfg.itl_slo_ticks):
            return SloViolation(
                f"tenant {tenant!r}: worst inter-token gap "
                f"{max_itl_ticks} ticks over the "
                f"{cfg.itl_slo_ticks}-tick bound",
                tenant=tenant, metric="itl", observed=max_itl_ticks,
                bound=cfg.itl_slo_ticks)
        return None

    # -- observability ----------------------------------------------------

    def gauge_snapshot(self) -> Dict[str, Dict[str, float]]:
        """Per-tenant gauge rows for ``Tracer.tenant_gauges``."""
        return {name: {"pages": float(self.ledger.charged(name)),
                       "vtime": self._vtime[name],
                       "tokens": float(self._tokens[name])}
                for name in sorted(self.tenants)}

    def __repr__(self):
        rows = ", ".join(
            f"{name}(w={self.tenants[name].weight}, "
            f"v={self._vtime[name]:.1f})"
            for name in sorted(self.tenants))
        return f"TenancyPolicy({rows})"

"""Request outcomes and the serving errors (counterpart of the part of
``apex_tpu/serving/health.py`` the ported slices need).

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

"""Request outcomes and the non-finite-logits error (counterpart of the
part of ``apex_tpu/serving/health.py`` this slice needs).

This slice has no quarantine or retry path: a non-finite logits row
(or an out-of-vocabulary sample) raises :class:`NonFiniteLogits` and is
never committed. The fault taxonomy, retry budgets, deadlines and the
watchdog are later slices.
"""

import dataclasses
from typing import Optional, Tuple


class ServingError(RuntimeError):
    """Base of the serving failure taxonomy."""


class NonFiniteLogits(ServingError):
    """A prefill or decode step produced NaN/Inf logits (or the sampler
    returned a token outside the vocabulary) for a slot."""


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

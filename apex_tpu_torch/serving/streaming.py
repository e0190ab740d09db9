"""Per-token streaming delivery for the serving front-end (counterpart
of ``apex_tpu/serving/streaming.py``: the same host code).

The scheduler commits tokens in bursts — one per plain decode tick,
1..k+1 per speculative verify tick, none during a prefill chunk — but
callers of a serving API want them as they land, not as a wholesale
:class:`~apex_tpu_torch.serving.health.RequestOutcome` at the end. This
module is that fan-out layer: a :class:`TokenStream` per request, fed
by a :class:`StreamMux` the scheduler stages committed tokens into at
commit time and flushes ONCE at the end of every tick, so each flush
delivers exactly the tokens that tick committed (1..k+1 under
speculation, possibly zero under chunked prefill).

Two contracts anchor the design:

- **Delivery is host-side fan-out, never part of the committed
  stream.** The mux only observes tokens the scheduler already
  committed; it never touches slots, queues, fault draws on the
  engine's sites, or sampling keys — a scheduler run with streaming
  on commits byte-identical outcomes to one with streaming off.
- **Strict prefix on failure.** Each flush consults the
  ``stream_emit`` fault site once per request with staged tokens, in
  sorted request order (deterministic draw indices). A fired draw
  drops that request's ENTIRE staged batch, records a typed
  :class:`~apex_tpu_torch.serving.health.StreamFailed` on the stream, and
  closes it — so ``stream.delivered`` is always a prefix of the final
  ``outcome.tokens``, and a STRICT prefix whenever the stream failed.
  The request itself keeps decoding: a consumer losing its socket
  must not cost the tenant its tokens.

Host state: streams, staging buffers and the injector's draw counters
live here.
"""

from typing import Callable, Dict, List, Optional, Tuple

from apex_tpu_torch.serving.faults import FaultInjector
from apex_tpu_torch.serving.health import ServingStats, StreamFailed
from apex_tpu_torch.serving.observe import Tracer


class TokenStream:
    """One request's delivery-side view: the tokens actually handed to
    the consumer (``delivered`` — a prefix of the committed stream),
    the close state, and the typed :class:`StreamFailed` if delivery
    died early. Constructed by :meth:`StreamMux.open` at ``submit()``;
    read it from ``scheduler.streams.streams[request_id]``."""

    __slots__ = ("request_id", "tenant", "delivered", "closed",
                 "reason", "error")

    def __init__(self, request_id: int, tenant: str = "default"):
        self.request_id = request_id
        self.tenant = tenant
        self.delivered: List[int] = []
        self.closed = False
        self.reason: Optional[str] = None   # outcome reason once closed
        self.error: Optional[StreamFailed] = None

    @property
    def failed(self) -> bool:
        return self.error is not None

    def as_dict(self) -> Dict:
        return {"request_id": self.request_id, "tenant": self.tenant,
                "delivered": list(self.delivered), "closed": self.closed,
                "reason": self.reason,
                "error": None if self.error is None else str(self.error)}

    def __repr__(self):
        return (f"TokenStream(rid={self.request_id}, "
                f"tenant={self.tenant!r}, n={len(self.delivered)}, "
                f"closed={self.closed}, failed={self.failed})")


class StreamMux:
    """The scheduler-facing staging buffer over all open streams.

    The scheduler calls :meth:`stage` at every commit point (O(1)
    append), :meth:`finish` when a request terminates, and
    :meth:`flush` once at the end of every tick. ``flush`` walks the
    staged requests in sorted id order, draws ``stream_emit`` once per
    request batch, and either extends the stream (optionally invoking
    ``sink(request_id, tenant, tokens)`` — the caller's delivery
    callback) or drops the batch under the strict-prefix contract.

    Constructed implicitly by ``ContinuousBatchingScheduler(...,
    streams=True)`` — which wires the engine's injector/tracer/stats
    so fault draws, instants and counters land in the same
    deterministic sequence the chaos tier replays — or explicitly when
    the caller wants its own ``sink``.
    """

    def __init__(self, injector: Optional[FaultInjector] = None,
                 tracer: Optional[Tracer] = None,
                 stats: Optional[ServingStats] = None,
                 sink: Optional[Callable[[int, str, List[int]],
                                         None]] = None):
        self.injector = injector if injector is not None else FaultInjector()
        self.tracer = tracer if tracer is not None else Tracer(enabled=False)
        self.stats = stats if stats is not None else ServingStats()
        self.sink = sink
        self.streams: Dict[int, TokenStream] = {}
        self._staged: Dict[int, List[int]] = {}
        self._closing: Dict[int, str] = {}  # rid -> reason, this tick

    def open(self, request_id: int, tenant: str = "default") -> TokenStream:
        st = TokenStream(request_id, tenant)
        self.streams[request_id] = st
        return st

    def stage(self, request_id: int, token: int) -> None:
        """Record one committed token for the next flush (called from
        the scheduler's commit bookkeeping — keep it O(1))."""
        buf = self._staged.get(request_id)
        if buf is None:
            buf = self._staged[request_id] = []
        buf.append(token)

    def finish(self, request_id: int, reason: str) -> None:
        """Mark a request terminated: its stream closes at the next
        flush, AFTER its final staged batch delivers."""
        self._closing[request_id] = reason

    def flush(self) -> int:
        """End-of-tick delivery pass; returns tokens delivered. One
        ``stream_emit`` draw per request with staged tokens, in sorted
        request order — draw indices are a pure function of the commit
        history, so chaos runs replay bit-for-bit."""
        delivered = 0
        for rid in sorted(self._staged):
            toks = self._staged[rid]
            st = self.streams.get(rid)
            if st is None or st.closed or not toks:
                continue  # failed/closed earlier: batch drops, prefix holds
            fired, _ = self.injector.draw("stream_emit")
            if fired:
                idx = self.injector.calls("stream_emit") - 1
                err = StreamFailed(
                    f"stream for request {rid} dropped a "
                    f"{len(toks)}-token batch at stream_emit[{idx}]; "
                    f"{len(st.delivered)} delivered tokens remain a "
                    f"strict prefix of the committed stream",
                    request_id=rid, delivered=len(st.delivered),
                    dropped=len(toks))
                st.error = self.tracer.attach(err)
                st.closed = True
                self.stats.stream_failures += 1
                if self.tracer.enabled:
                    self.tracer.instant("stream_emit", request_id=rid,
                                        tenant=st.tenant, ok=False,
                                        dropped=len(toks))
                continue
            st.delivered.extend(toks)
            delivered += len(toks)
            self.stats.stream_batches += 1
            self.stats.stream_tokens += len(toks)
            if self.sink is not None:
                self.sink(rid, st.tenant, list(toks))
            if self.tracer.enabled:
                self.tracer.instant("stream_emit", request_id=rid,
                                    tenant=st.tenant, tokens=len(toks))
        self._staged.clear()
        for rid in sorted(self._closing):
            st = self.streams.get(rid)
            if st is not None and not st.closed:
                st.closed = True
                st.reason = self._closing[rid]
        self._closing.clear()
        return delivered

    def snapshot(self) -> List[Tuple[int, int, bool, bool]]:
        """``(request_id, delivered, closed, failed)`` rows in id
        order — the diagnostic view for tests and error payloads."""
        return [(rid, len(st.delivered), st.closed, st.failed)
                for rid, st in sorted(self.streams.items())]

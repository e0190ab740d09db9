"""Host-side observability for the serving engine: tracer, metrics and
flight recorder (counterpart of ``apex_tpu/serving/observe.py``, host
Python kept as the port's own copy: the same names and behaviour).

- :class:`Tracer` — span/event tracing of the scheduler's tick loop.
  Every event carries TWO clocks: the deterministic tick clock (the
  scheduler's work-charged ``clock``: two runs of the same requests give
  equal tick-clock streams) and host wall time (``perf_counter``, for
  humans and Perfetto, outside that contract). ``dump_jsonl`` writes
  chrome-tracing / Perfetto "JSON object per line" events
  (``ph``/``ts``/``name``; ``ts`` is ticks scaled so one tick renders as
  1 ms, the wall time rides in ``args``).
- :class:`MetricsRegistry` — counters, gauges and fixed-bucket
  histograms (TTFT and inter-token gaps in ticks, committed tokens a
  tick, per-stream acceptance, pool occupancy, queue depth), exported as
  JSON (``as_dict``) and Prometheus text (``to_prometheus``).
  ``health.ServingStats`` is a view over this registry: the counter
  block and the exports share storage and cannot drift.
- :class:`FlightRecorder` — a bounded ring of the most recent trace
  events, attached to a typed ``ServingError``'s ``payload``.

Spans measure HOST time. On the card a span closes when the host has
queued its work, not when the device has run it: the tracer adds no
``torch.cuda.synchronize``, since tracing must never perturb streams or
timings. A span's ``dur`` is therefore host time, never device time.

The inert contract: an engine built without a tracer gets
``Tracer(enabled=False)``, and every hook site in the scheduler is
guarded by one attribute check (``if trc.enabled:``) — the disabled
path adds one branch a site and records nothing.
"""

import bisect
import json
import time
from collections import deque
from typing import Any, Dict, Iterable, List, NamedTuple, Optional, Tuple

#: Per-tick phase spans, in tick order. ``prefill`` one whole-prompt
#: forward at admission; ``exec`` the decode / verify / tree-verify
#: step inside the engine; ``chunk_prefill`` one prompt-chunk forward
#: (several may run a tick, one span each); the rest are host-side
#: scheduler phases. ``page_transfer`` and ``reshard`` (cross-replica
#: page handoffs) keep the reference's names for its later slices.
PHASES = ("prefill", "draft", "prepare_decode", "exec", "accept",
          "commit", "chunk_prefill", "page_transfer", "reshard")

#: Per-request lifecycle instants. ``host_spill`` / ``host_promote``
#: mark KV pages crossing the device <-> host-tier boundary (one instant
#: per spilled page / per promoted chain, ``ok=False`` on a fault or
#: verification failure); ``rebalance`` marks the pool router moving
#: decode placement onto a sibling replica (the N-way failover pick,
#: chosen by pages-free headroom). (``prefill`` is a SPAN, not an
#: instant — it lives in :data:`PHASES`.)
LIFECYCLE = ("submitted", "admitted", "first_token",
             "preempted", "retried", "quarantined", "failover",
             "finished", "host_spill", "host_promote", "rebalance",
             "stream_emit", "slo_violation")

#: Default histogram buckets for tick-denominated latencies (TTFT,
#: inter-token). Roughly geometric: fine where SLOs live, coarse in
#: the tail; +Inf is implicit.
TICK_BUCKETS = (1.0, 2.0, 3.0, 4.0, 6.0, 8.0, 12.0, 16.0, 24.0, 32.0,
                48.0, 64.0, 96.0, 128.0, 192.0, 256.0, 384.0, 512.0)


def _label_key(labels: Optional[Dict[str, Any]]) -> Tuple:
    return tuple(sorted((labels or {}).items()))


def _label_str(labels: Dict[str, Any]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
    return "{%s}" % inner


class Counter:
    """Monotonic counter. ``value`` is plain int — ``ServingStats``
    aliases these directly, so reads/writes through either face see
    the same storage."""

    kind = "counter"

    def __init__(self, name: str, help: str = "",
                 labels: Optional[Dict[str, Any]] = None):
        self.name = name
        self.help = help
        self.labels = dict(labels or {})
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n

    def scalar(self):
        return self.value


class Gauge:
    """Last-write-wins instantaneous value (queue depth, pool
    occupancy, per-stream acceptance)."""

    kind = "gauge"

    def __init__(self, name: str, help: str = "",
                 labels: Optional[Dict[str, Any]] = None):
        self.name = name
        self.help = help
        self.labels = dict(labels or {})
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = v

    def scalar(self):
        return self.value


class Histogram:
    """Fixed-bucket histogram with Prometheus cumulative-``le``
    semantics: ``bounds`` are ascending finite upper edges, a final
    +Inf bucket is implicit. ``quantile`` interpolates linearly inside
    the containing bucket, so its error is bounded by that bucket's
    width (the overflow bucket interpolates toward the observed max)."""

    kind = "histogram"

    def __init__(self, name: str, buckets: Iterable[float] = TICK_BUCKETS,
                 help: str = "", labels: Optional[Dict[str, Any]] = None):
        self.name = name
        self.help = help
        self.labels = dict(labels or {})
        self.bounds = tuple(float(b) for b in buckets)
        if not self.bounds or list(self.bounds) != sorted(set(self.bounds)):
            raise ValueError(
                f"histogram {name!r}: buckets must be ascending and "
                f"non-empty, got {self.bounds}")
        self.counts = [0] * (len(self.bounds) + 1)  # [-1] = +Inf
        self.count = 0
        self.sum = 0.0
        self.vmin: Optional[float] = None
        self.vmax: Optional[float] = None

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.sum += v
        self.vmin = v if self.vmin is None else min(self.vmin, v)
        self.vmax = v if self.vmax is None else max(self.vmax, v)
        self.counts[bisect.bisect_left(self.bounds, v)] += 1

    def quantile(self, q: float) -> Optional[float]:
        """Bucket-interpolated estimate of the q-quantile (0..1), or
        ``None`` if empty."""
        if not self.count:
            return None
        target = q * self.count
        cum = 0
        for i, n in enumerate(self.counts):
            if not n:
                continue
            if cum + n >= target:
                lo = self.vmin if i == 0 else self.bounds[i - 1]
                hi = self.vmax if i == len(self.bounds) else self.bounds[i]
                lo = min(lo, hi)
                frac = max(0.0, min(1.0, (target - cum) / n))
                return lo + frac * (hi - lo)
            cum += n
        return self.vmax

    def scalar(self):
        d = {"count": self.count, "sum": self.sum,
             "buckets": dict(zip([*map(str, self.bounds), "+Inf"],
                                 self.counts))}
        for q, tag in ((0.5, "p50"), (0.95, "p95"), (0.99, "p99")):
            v = self.quantile(q)
            if v is not None:
                d[tag] = round(v, 4)
        return d


class MetricsRegistry:
    """Get-or-create registry of named metrics, keyed by
    ``(name, labels)``. Deterministic: iteration follows creation
    order, no clocks, no randomness."""

    def __init__(self):
        self._metrics: Dict[Tuple, Any] = {}

    def _get(self, cls, name, help, labels, **kw):
        key = (name, _label_key(labels))
        m = self._metrics.get(key)
        if m is None:
            m = cls(name, help=help, labels=labels, **kw)
            self._metrics[key] = m
        elif not isinstance(m, cls):
            raise TypeError(
                f"metric {name!r} already registered as {m.kind}, "
                f"requested {cls.kind}")
        return m

    def counter(self, name: str, help: str = "",
                labels: Optional[Dict[str, Any]] = None) -> Counter:
        return self._get(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "",
              labels: Optional[Dict[str, Any]] = None) -> Gauge:
        return self._get(Gauge, name, help, labels)

    def histogram(self, name: str, buckets: Iterable[float] = TICK_BUCKETS,
                  help: str = "",
                  labels: Optional[Dict[str, Any]] = None) -> Histogram:
        return self._get(Histogram, name, help, labels, buckets=buckets)

    def get(self, name: str,
            labels: Optional[Dict[str, Any]] = None) -> Optional[Any]:
        return self._metrics.get((name, _label_key(labels)))

    def quantiles(self, name: str,
                  qs: Tuple[float, ...] = (0.5, 0.95, 0.99),
                  labels: Optional[Dict[str, Any]] = None,
                  ) -> Optional[Dict[str, float]]:
        """``{"p50": ..., "p95": ..., "p99": ...}`` for a histogram, or
        ``None`` if absent/empty — the bench ``extra`` helper."""
        h = self.get(name, labels)
        if h is None or not isinstance(h, Histogram) or not h.count:
            return None
        return {f"p{int(q * 100)}": h.quantile(q) for q in qs}

    def as_dict(self) -> Dict[str, Any]:
        out = {}
        for (name, _), m in self._metrics.items():
            out[name + _label_str(m.labels)] = m.scalar()
        return out

    def to_prometheus(self) -> str:
        """Prometheus text exposition format (0.0.4)."""
        lines: List[str] = []
        seen_header = set()
        for (name, _), m in self._metrics.items():
            if name not in seen_header:
                seen_header.add(name)
                if m.help:
                    lines.append(f"# HELP {name} {m.help}")
                lines.append(f"# TYPE {name} {m.kind}")
            ls = _label_str(m.labels)
            if m.kind == "histogram":
                cum = 0
                for bound, n in zip([*m.bounds, float("inf")], m.counts):
                    cum += n
                    le = "+Inf" if bound == float("inf") else repr(bound)
                    sep = "," if m.labels else ""
                    inner = ls[1:-1] + sep if m.labels else ""
                    lines.append(
                        f'{name}_bucket{{{inner}le="{le}"}} {cum}')
                lines.append(f"{name}_sum{ls} {m.sum}")
                lines.append(f"{name}_count{ls} {m.count}")
            else:
                lines.append(f"{name}{ls} {m.value}")
        return "\n".join(lines) + "\n"


class TraceEvent(NamedTuple):
    """One trace record. ``tick`` (+ name/ph/ids/args) is the
    deterministic face — :meth:`tick_key` deliberately excludes the
    wall-clock fields so replay-exactness can be asserted byte-for-byte
    across chaos runs. ``wall``/``dur`` (perf_counter seconds) are the
    human face, surfaced only in the Perfetto dump. A NamedTuple, not a
    dataclass: construction sits on the per-tick hot path and tuple
    ``__new__`` is severalfold cheaper than a frozen-dataclass init."""

    name: str
    ph: str                 # "X" complete span | "i" instant
    tick: int
    wall: float
    dur: float = 0.0
    request_id: int = -1
    slot: int = -1
    args: Tuple[Tuple[str, Any], ...] = ()

    def tick_key(self) -> Tuple:
        return (self.name, self.ph, self.tick, self.request_id,
                self.slot, self.args)

    def to_chrome(self) -> Dict[str, Any]:
        """chrome://tracing / Perfetto event dict. ``ts`` is the tick
        clock scaled by 1000 (ticks render as milliseconds; wall-clock
        span durations ride in microseconds, so sub-tick phase timing
        stays visible)."""
        args = dict(self.args)
        args["tick"] = self.tick
        args["wall_s"] = self.wall
        if self.request_id >= 0:
            args["request_id"] = self.request_id
        d = {"name": self.name, "ph": self.ph, "ts": self.tick * 1000,
             "pid": 0, "tid": max(self.slot, 0), "args": args}
        if self.ph == "X":
            d["dur"] = max(round(self.dur * 1e6), 1)
        else:
            d["s"] = "t"  # instant scope: thread
        return d


class FlightRecorder:
    """Bounded ring of the most recent trace events — the black box a
    typed ``ServingError`` carries out of a chaos failure."""

    def __init__(self, capacity: int = 256):
        self.capacity = capacity
        self._ring: deque = deque(maxlen=capacity)

    def record(self, evt: TraceEvent) -> None:
        self._ring.append(evt)

    def events(self) -> List[TraceEvent]:
        return list(self._ring)

    def clear(self) -> None:
        self._ring.clear()

    def __len__(self) -> int:
        return len(self._ring)


class Tracer:
    """Span/event tracer + metric hooks for the scheduler's tick loop.

    Hook contract (mirrors the inert ``FaultInjector``): the scheduler
    holds ``trc = self.tracer`` and guards EVERY call with
    ``if trc.enabled:`` — a disabled tracer costs one attribute check
    per site and records nothing. The scheduler advances :attr:`tick`
    once per loop iteration, so all events within a tick share its
    deterministic timestamp.
    """

    def __init__(self, enabled: bool = True,
                 registry: Optional[MetricsRegistry] = None,
                 recorder: Optional[FlightRecorder] = None,
                 max_events: int = 1_000_000):
        self.enabled = enabled
        self.registry = registry if registry is not None else MetricsRegistry()
        self.recorder = recorder if recorder is not None else FlightRecorder()
        self.events: List[TraceEvent] = []
        self.tick = 0
        self.dropped = 0
        self._open: Dict[str, Tuple[int, float]] = {}
        self._max_events = max_events
        # per-tick metric hooks resolve their registry entry once and
        # keep the object — the (name, labels)-keyed lookup is off the
        # hot path after first use
        self._hot: Dict[Any, Any] = {}

    # -- event recording ------------------------------------------------

    def set_tick(self, tick: int) -> None:
        self.tick = int(tick)

    def _record(self, evt: TraceEvent) -> None:
        if len(self.events) < self._max_events:
            self.events.append(evt)
        else:
            self.dropped += 1  # ring below still sees it
        self.recorder.record(evt)

    def instant(self, name: str, request_id: int = -1, slot: int = -1,
                **args) -> None:
        self._record(TraceEvent(
            name, "i", self.tick, time.perf_counter(), 0.0,
            request_id, slot,
            tuple(sorted(args.items())) if args else ()))

    def begin(self, name: str) -> None:
        """Open a span; close it with :meth:`end`. Spans are keyed by
        name — the tick loop is single-threaded and phases never nest
        under the same name."""
        self._open[name] = (self.tick, time.perf_counter())

    def end(self, name: str, request_id: int = -1, slot: int = -1,
            **args) -> None:
        tick, t0 = self._open.pop(name, (self.tick, time.perf_counter()))
        self._record(TraceEvent(
            name, "X", tick, t0, time.perf_counter() - t0,
            request_id, slot,
            tuple(sorted(args.items())) if args else ()))

    # -- views / export -------------------------------------------------

    def tick_stream(self) -> Tuple[Tuple, ...]:
        """The deterministic event stream: every event's
        :meth:`~TraceEvent.tick_key`, wall clock excluded. Two runs at
        the same seed under a pinned fault schedule must produce equal
        tick streams (chaos replay contract)."""
        return tuple(e.tick_key() for e in self.events)

    def flight(self, request_id: Optional[int] = None) -> List[Dict]:
        """The flight-recorder ring as chrome dicts (JSON-safe, ready
        for an error payload), optionally filtered to one request."""
        evts = self.recorder.events()
        if request_id is not None:
            evts = [e for e in evts if e.request_id == request_id]
        return [e.to_chrome() for e in evts]

    def attach(self, err) -> Any:
        """Attach the flight-recorder ring to a typed ``ServingError``
        payload and return it."""
        try:
            err.payload["flight"] = self.flight()
        except AttributeError:
            pass  # foreign exception without a payload dict
        return err

    def dump_jsonl(self, path: str) -> int:
        """Write one chrome-tracing JSON object per line (Perfetto and
        chrome://tracing both ingest this). Returns the event count."""
        with open(path, "w") as fh:
            for e in self.events:
                fh.write(json.dumps(e.to_chrome(), sort_keys=True) + "\n")
        return len(self.events)

    # -- metric hooks (names are the stable export surface) -------------

    def observe_ttft(self, ticks: int) -> None:
        h = self._hot.get("ttft")
        if h is None:
            h = self._hot["ttft"] = self.registry.histogram(
                "serving_ttft_ticks",
                help="submit -> first committed token, in scheduler "
                     "ticks")
        h.observe(ticks)

    def observe_itl(self, ticks: int) -> None:
        h = self._hot.get("itl")
        if h is None:
            h = self._hot["itl"] = self.registry.histogram(
                "serving_itl_ticks",
                help="inter-token gap, in scheduler ticks (0 within a "
                     "multi-token speculative commit)")
        h.observe(ticks)

    def observe_tenant_ttft(self, tenant: str, ticks: int) -> None:
        h = self._hot.get(("tttft", tenant))
        if h is None:
            h = self._hot[("tttft", tenant)] = self.registry.histogram(
                "serving_tenant_ttft_ticks",
                help="submit -> first committed token, in scheduler "
                     "ticks, per tenant",
                labels={"tenant": tenant})
        h.observe(ticks)

    def observe_tenant_itl(self, tenant: str, ticks: int) -> None:
        h = self._hot.get(("titl", tenant))
        if h is None:
            h = self._hot[("titl", tenant)] = self.registry.histogram(
                "serving_tenant_itl_ticks",
                help="inter-token gap, in scheduler ticks, per tenant",
                labels={"tenant": tenant})
        h.observe(ticks)

    def tenant_gauges(self, snapshot: Dict[str, Dict[str, float]]) -> None:
        """End-of-tick tenancy rollup: per-tenant page reservations,
        fair-share virtual time, and cumulative committed tokens
        (``snapshot`` comes from ``TenancyPolicy.gauge_snapshot``)."""
        hot = self._hot
        for tenant in sorted(snapshot):
            gs = hot.get(("tenant", tenant))
            if gs is None:
                r = self.registry
                gs = hot[("tenant", tenant)] = (
                    r.gauge("serving_tenant_pages_charged",
                            help="pages reserved against the tenant's "
                                 "quota by its live requests",
                            labels={"tenant": tenant}),
                    r.gauge("serving_tenant_share_vtime",
                            help="weighted fair-share virtual time "
                                 "(charged tokens / weight) — tenants "
                                 "advance together when shares match "
                                 "their weights",
                            labels={"tenant": tenant}),
                    r.gauge("serving_tenant_tokens",
                            help="tokens charged to the tenant so far "
                                 "(committed + prefill chunk tokens)",
                            labels={"tenant": tenant}))
            g_pages, g_vtime, g_tokens = gs
            row = snapshot[tenant]
            g_pages.set(row["pages"])
            g_vtime.set(row["vtime"])
            g_tokens.set(row["tokens"])

    def tenant_latency_summary(self, tenant: str) -> Dict[str, float]:
        """Per-tenant ``{ttft_p50: ..., itl_p99: ...}`` quantile dict —
        the bench helper behind the noisy-neighbor contract; silently
        omits empty histograms."""
        out: Dict[str, float] = {}
        for short, name in (("ttft", "serving_tenant_ttft_ticks"),
                            ("itl", "serving_tenant_itl_ticks")):
            qs = self.registry.quantiles(name,
                                         labels={"tenant": tenant})
            if qs:
                for tag, v in qs.items():
                    out[f"{short}_{tag}"] = round(v, 3)
        return out

    def stream_acceptance(self, slot: int, rate: float) -> None:
        g = self._hot.get(("acc", slot))
        if g is None:
            g = self._hot[("acc", slot)] = self.registry.gauge(
                "serving_stream_acceptance_rate",
                help="per-stream speculative acceptance rate, last tick",
                labels={"slot": slot})
        g.set(rate)

    def tick_metrics(self, committed: int, queue_depth: int,
                     pool: Optional[Dict[str, float]] = None) -> None:
        """End-of-tick rollup: committed-token histogram, queue-depth
        gauge, and (paged engines) pool gauges."""
        hot = self._hot
        if "tick" not in hot:
            r = self.registry
            hot["tick"] = (
                r.histogram(
                    "serving_committed_tokens_per_tick",
                    buckets=(0.0, 1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0),
                    help="tokens committed across all slots in one tick"),
                r.gauge("serving_queue_depth",
                        help="requests waiting for admission"))
        h_commit, g_queue = hot["tick"]
        h_commit.observe(committed)
        g_queue.set(queue_depth)
        if pool:
            if "pool" not in hot:  # dense engines never create these
                r = self.registry
                hot["pool"] = (
                    r.gauge("serving_pages_free",
                            help="free pages in the pool"),
                    r.gauge("serving_pages_cached",
                            help="pages held only by the prefix cache "
                                 "(evictable)"),
                    r.gauge("serving_page_pool_occupancy",
                            help="fraction of usable pages referenced"))
            g_free, g_cached, g_occ = hot["pool"]
            g_free.set(pool["free"])
            g_cached.set(pool["cached"])
            g_occ.set(pool["occupancy"])
            if "host_pages" in pool:  # host-tier engines only
                if "host" not in hot:
                    r = self.registry
                    hot["host"] = (
                        r.gauge("serving_page_pool_hbm_used",
                                help="HBM pages currently referenced"),
                        r.gauge("serving_page_pool_host_pages",
                                help="pages resident in the host spill "
                                     "tier"),
                        r.gauge("serving_page_pool_host_bytes",
                                help="bytes resident in the host spill "
                                     "tier (headers + payload + scales)"),
                        r.gauge("serving_page_pool_host_hit_rate",
                                help="host-tier registry hit rate since "
                                     "start"))
                g_hbm, g_hp, g_hb, g_hr = hot["host"]
                g_hbm.set(pool["hbm_used"])
                g_hp.set(pool["host_pages"])
                g_hb.set(pool["host_bytes"])
                g_hr.set(pool["host_hit_rate"])

    def latency_summary(self) -> Dict[str, float]:
        """``{ttft_p50: ..., itl_p99: ...}`` — flat quantile dict for
        bench ``extra`` blocks; silently omits empty histograms."""
        out: Dict[str, float] = {}
        for short, name in (("ttft", "serving_ttft_ticks"),
                            ("itl", "serving_itl_ticks")):
            qs = self.registry.quantiles(name)
            if qs:
                for tag, v in qs.items():
                    out[f"{short}_{tag}"] = round(v, 3)
        return out

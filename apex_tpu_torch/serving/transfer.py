"""Cross-replica page handoff for disaggregated serving (counterpart of
``apex_tpu/serving/transfer.py``), and the page extract and insert steps
the handoff and the host spill tier share.

The extract gathers whole pages out of a ``PagedKVCache``'s pool by page
id; the insert scatters tiles back into the pages a pool allocated, IN
PLACE (the port's form of the JAX package's donated cache). Tiles are
``(layers, n_pages, heads, page_size, head_dim)`` in the pool dtype,
scale planes ``(layers, n_pages, heads)`` fp32. The host spill tier
spills an evicted prefix page through the extract and promotes it back
through one batched insert, bit for bit.

:class:`PageTransfer` is the verified channel the router
(``serving.router``) moves a prompt's finished pages over, from the
prefill replica's pool to the decode replica's:

- every payload is checksummed (:func:`transfer_checksum`: sha256 over
  the prompt's final chained page key, then the k bytes, then the v
  bytes), so a payload verifies only against the prompt whose pages it
  carries; the receiver recomputes before installing, and a mismatch
  (the ``page_recv`` site flips one staged byte) QUARANTINES the
  payload: the tiles never reach the receiving cache;
- each handoff gets ``max_retries`` re-attempts (a ``page_send`` drop
  counts too); exhaustion raises the typed
  :class:`~apex_tpu_torch.serving.health.TransferFailed` /
  ``TransferCorrupt`` and the router serves the admission colocated;
  every attempt is also a probe of the remote replica's
  :class:`~apex_tpu_torch.serving.health.ReplicaHealth` ladder;
- one ``page_transfer`` tracer span per handoff, per-replica labeled
  counters, and the ``serving_transfer_ticks`` histogram of the tick
  cost the router charges.

The payload crosses the host (device -> host numpy -> device): a bf16
tile as its 16-bit integer view (numpy has no bf16), whose bytes are
the JAX package's, so the digest of a tile is the reference's.
:class:`PageReshard` is the device-to-device tier of the same channel
(its own fault sites, span, counters and typed
:class:`~apex_tpu_torch.serving.health.ReshardFailed`) at the
reference's single-process default, the host round trip; the transfer
over two sub-meshes (``make_tile_transfer_fns``,
``make_reshard_extract_fn``) waits for ROADMAP item A4.5.

The channel objects are host state (attempt counters, metric handles).
"""

import hashlib
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from apex_tpu_torch.serving.faults import FaultInjector
from apex_tpu_torch.serving.health import (
    ReshardFailed, ServingStats, TransferCorrupt, TransferFailed,
)
from apex_tpu_torch.serving.observe import Tracer

#: ``serving_transfer_ticks`` histogram buckets: a handoff is charged a
#: handful of decode-step equivalents.
TRANSFER_TICK_BUCKETS = (1.0, 2.0, 3.0, 4.0, 6.0, 8.0, 12.0, 16.0,
                         24.0, 32.0)


def _ids(cache, page_ids) -> torch.Tensor:
    return torch.as_tensor(page_ids, dtype=torch.long,
                           device=cache.k.device)


def _tile(pool: torch.Tensor, x) -> torch.Tensor:
    """A host tile as ``pool``'s dtype on its device; bf16 tiles cross
    the host as 16-bit integer bits (numpy has no bf16) and are
    reinterpreted, not converted."""
    t = torch.as_tensor(x)
    if t.dtype != pool.dtype and not t.dtype.is_floating_point \
            and t.element_size() == pool.element_size():
        t = t.view(pool.dtype)
    return t.to(device=pool.device, dtype=pool.dtype)


def make_extract_pages_fn() -> Callable:
    """``(cache, page_ids) -> (k_tile, v_tile)``: the identified pages of
    every layer, gathered (copies)."""

    def extract(cache, page_ids):
        ids = _ids(cache, page_ids)
        return cache.k[:, ids], cache.v[:, ids]

    return extract


def make_insert_pages_fn() -> Callable:
    """``(cache, page_ids, k_tile, v_tile) -> cache``: scatter the tiles
    into the identified pages of every layer, in place."""

    def insert(cache, page_ids, k_tile, v_tile):
        ids = _ids(cache, page_ids)
        cache.k[:, ids] = _tile(cache.k, k_tile)
        cache.v[:, ids] = _tile(cache.v, v_tile)
        return cache

    return insert


def make_extract_pages_quant_fn() -> Callable:
    """:func:`make_extract_pages_fn` for the int8 pool: ``(cache,
    page_ids) -> (k_tile, v_tile, k_scale, v_scale)``, the fp32 scale
    planes with the tiles (a page's rows mean nothing without the scales
    they were quantized against)."""

    def extract(cache, page_ids):
        ids = _ids(cache, page_ids)
        return (cache.k[:, ids], cache.v[:, ids], cache.k_scale[:, ids],
                cache.v_scale[:, ids])

    return extract


def make_insert_pages_quant_fn() -> Callable:
    """:func:`make_insert_pages_fn` for the int8 pool: ``(cache,
    page_ids, k_tile, v_tile, k_scale, v_scale) -> cache``, tiles and
    scale planes scattered in place, so the promoted page dequantizes to
    the spilled values."""

    def insert(cache, page_ids, k_tile, v_tile, k_scale, v_scale):
        ids = _ids(cache, page_ids)
        cache.k[:, ids] = _tile(cache.k, k_tile)
        cache.v[:, ids] = _tile(cache.v, v_tile)
        cache.k_scale[:, ids] = _tile(cache.k_scale, k_scale)
        cache.v_scale[:, ids] = _tile(cache.v_scale, v_scale)
        return cache

    return insert


def _host(t: torch.Tensor) -> np.ndarray:
    """A tile as a host array; bf16 crosses as its 16-bit integer bits
    (numpy has no bf16), the bytes the JAX package's host copy holds."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy()


def _default_gather(k_tile, v_tile):
    return _host(k_tile), _host(v_tile)


def _default_shard(k_tile, v_tile):
    # the insert places host tiles on the receiving pool's device
    return k_tile, v_tile


def transfer_checksum(k_tile: np.ndarray, v_tile: np.ndarray,
                      chain_key: bytes) -> bytes:
    """sha256 over the prompt's final chained page key, then the staged
    k bytes, then the v bytes: integrity (a flipped bit) and identity (a
    payload verifies only against the prompt whose pages it carries) in
    one digest."""
    h = hashlib.sha256()
    h.update(chain_key)
    h.update(np.ascontiguousarray(k_tile).tobytes())
    h.update(np.ascontiguousarray(v_tile).tobytes())
    return h.digest()


class PageTransfer:
    """The verified handoff channel (see the module doc). One instance a
    router; every replica shares its injector and tracer, so fault draws
    and spans form one deterministic sequence.

    ``max_retries`` bounds RE-attempts a handoff (``max_retries + 1``
    attempts in all); ``gather_fn`` / ``shard_fn`` are the staging hop's
    two halves (device tiles -> host arrays, host arrays -> what the
    insert takes). The class attributes name the channel: the fault
    sites it draws, its span, its ``ServingStats`` fields and metric
    family; :class:`PageReshard` overrides exactly these, and the typed
    error of a lost budget, and shares ``ship``."""

    #: fault sites drawn an attempt: a drop before any byte moves, a
    #: corruption of the staged payload in flight
    send_site = "page_send"
    recv_site = "page_recv"
    #: the tracer span, one a handoff (its retries inside it)
    span = "page_transfer"
    #: ``ServingStats`` fields ``<prefix>_retries`` / ``_corrupt`` /
    #: ``_failures``, and ``delivered_stat`` for verified deliveries
    stat_prefix = "transfer"
    delivered_stat = "transfers"
    #: the per-replica labeled metric family in the registry
    metric_prefix = "serving_transfer"

    def __init__(self, injector: Optional[FaultInjector] = None,
                 tracer: Optional[Tracer] = None,
                 stats: Optional[ServingStats] = None,
                 max_retries: int = 2,
                 gather_fn: Callable = _default_gather,
                 shard_fn: Callable = _default_shard):
        if max_retries < 0:
            raise ValueError(
                f"max_retries must be >= 0, got {max_retries}")
        self.injector = injector or FaultInjector()
        self.tracer = tracer if tracer is not None \
            else Tracer(enabled=False)
        self.stats = stats if stats is not None \
            else ServingStats(registry=self.tracer.registry)
        self.max_retries = max_retries
        self.gather_fn = gather_fn
        self.shard_fn = shard_fn
        self._extract = make_extract_pages_fn()
        self._hot = {}

    # -- per-replica labeled metrics ------------------------------------

    def _counters(self, replica: str):
        c = self._hot.get(replica)
        if c is None:
            r = self.tracer.registry
            p = self.metric_prefix
            labels = {"replica": replica}
            c = self._hot[replica] = (
                r.counter(f"{p}_src_bytes_total",
                          help="page-handoff bytes shipped from this "
                               "replica (verified payloads only)",
                          labels=labels),
                r.counter(f"{p}_src_retries_total",
                          help="handoff attempts retried against this "
                               "replica", labels=labels),
                r.counter(f"{p}_src_failures_total",
                          help="handoffs abandoned against this "
                               "replica (budget exhausted)",
                          labels=labels),
                r.histogram(f"{p}_ticks",
                            buckets=TRANSFER_TICK_BUCKETS,
                            help="deterministic tick cost charged per "
                                 "delivered handoff",
                            labels=labels),
            )
        return c

    def _bump(self, field: str, n: int = 1) -> None:
        """Add ``n`` to the channel's ``<stat_prefix>_<field>`` stat."""
        name = f"{self.stat_prefix}_{field}"
        setattr(self.stats, name, getattr(self.stats, name) + n)

    def observe_ticks(self, replica: str, ticks: int) -> None:
        """Record the tick cost the router charged a delivered handoff
        (the router keeps the clock; the channel only records it)."""
        self._counters(replica)[3].observe(ticks)

    # -- the handoff ----------------------------------------------------

    def ship(self, src_engine, tokens: Sequence[int],
             src_pages: Sequence[int], *, replica: str = "remote",
             health=None) -> Tuple[Optional[np.ndarray],
                                   Optional[np.ndarray], int]:
        """Move ``src_pages`` (page ids in the SOURCE pool, in prompt
        order) of the prompt ``tokens`` out of ``src_engine``'s cache,
        verified: returns the host ``(k_tile, v_tile, attempts)`` for
        :func:`make_insert_pages_fn` on the receiver (``(None, None,
        attempts)`` for an empty batch: a fully deduped handoff still
        runs the control round trip, so it can still fault).
        ``attempts > 1`` means retries happened; the router charges each
        a backoff tick. Raises :class:`TransferFailed` /
        :class:`TransferCorrupt` when the budget is gone; every attempt's
        outcome is a probe of ``health`` (the remote replica's ladder)
        when given."""
        from apex_tpu_torch.serving.paging import prefix_page_keys

        inj = self.injector
        trc = self.tracer
        c_bytes, c_retries, c_failures, _ = self._counters(replica)
        chain_key = prefix_page_keys(
            [int(t) for t in tokens], src_engine.page_size)[-1]
        n_pages = len(src_pages)
        if trc.enabled:
            trc.begin(self.span)
        corrupt_last = False
        for attempt in range(self.max_retries + 1):
            if attempt:
                self._bump("retries")
                c_retries.inc()
            if inj.fire(self.send_site):
                # dropped before any byte moved
                if health is not None:
                    health.probe(False)
                continue
            if n_pages:
                k_tile, v_tile = self.gather_fn(*self._extract(
                    src_engine.cache, list(src_pages)))
                digest = transfer_checksum(k_tile, v_tile, chain_key)
                fired, payload = inj.draw(self.recv_site)
                if fired:
                    # in-flight corruption: one staged byte flipped, the
                    # payload picks which (deterministic per seed, site
                    # and index)
                    k_tile = np.array(k_tile, copy=True)
                    flat = k_tile.reshape(-1).view(np.uint8)
                    flat[payload % flat.size] ^= 0xFF
                if transfer_checksum(k_tile, v_tile,
                                     chain_key) != digest:
                    # quarantine: the tiles never reach the receiving
                    # cache; the retry re-extracts from the source
                    self._bump("corrupt")
                    corrupt_last = True
                    if health is not None:
                        health.probe(False)
                    continue
                corrupt_last = False
            else:
                k_tile = v_tile = None
                inj.draw(self.recv_site)  # the handshake keeps draw order
            setattr(self.stats, self.delivered_stat,
                    getattr(self.stats, self.delivered_stat) + 1)
            if n_pages:
                c_bytes.inc(int(k_tile.nbytes) + int(v_tile.nbytes))
            if health is not None:
                health.probe(True)
            if trc.enabled:
                trc.end(self.span, pages=n_pages,
                        attempts=attempt + 1, replica=replica)
            return k_tile, v_tile, attempt + 1
        self._bump("failures")
        c_failures.inc()
        if trc.enabled:
            trc.end(self.span, pages=n_pages,
                    attempts=self.max_retries + 1, replica=replica,
                    failed=True)
        err = self._budget_error(replica, self.max_retries + 1, n_pages,
                                 corrupt_last)
        raise self.tracer.attach(err) if trc.enabled else err

    def _budget_error(self, replica: str, attempts: int, n_pages: int,
                      corrupt_last: bool):
        """The typed error of a lost budget (the one place the reshard
        tier's taxonomy differs)."""
        cls = TransferCorrupt if corrupt_last else TransferFailed
        return cls(
            f"page handoff from replica {replica!r} lost all "
            f"{attempts} attempts ({n_pages} pages"
            f"{'; last payload corrupt' if corrupt_last else ''})",
            attempts=attempts, pages=n_pages)


class PageReshard(PageTransfer):
    """The device-to-device handoff tier: :class:`PageTransfer`'s
    verified channel under its own fault sites (``reshard_send`` /
    ``reshard_recv``), span, stats and metric family, priced by the pool
    router at the link's rate. At the single-process default the tiles
    take the host round trip, as in the JAX package. A lost budget
    raises the typed :class:`ReshardFailed` (``corrupt`` says whether
    the last payload was corrupt) and the pool router re-ships the same
    pages over its host-staged :class:`PageTransfer`. ``src_mesh`` /
    ``dst_mesh`` (the transfer between two sub-meshes) raise
    NotImplementedError naming ROADMAP A4.5."""

    send_site = "reshard_send"
    recv_site = "reshard_recv"
    span = "reshard"
    stat_prefix = "reshard"
    delivered_stat = "reshards"
    metric_prefix = "serving_reshard"

    def __init__(self, injector: Optional[FaultInjector] = None,
                 tracer: Optional[Tracer] = None,
                 stats: Optional[ServingStats] = None,
                 max_retries: int = 2,
                 src_mesh=None, dst_mesh=None):
        if src_mesh is not None or dst_mesh is not None:
            raise NotImplementedError(
                "PageReshard(src_mesh=..., dst_mesh=...): the reshard "
                "between two sub-meshes comes with tensor-parallel "
                "serving, ROADMAP item A4.5, not ported yet")
        super().__init__(injector=injector, tracer=tracer, stats=stats,
                         max_retries=max_retries)

    def _budget_error(self, replica: str, attempts: int, n_pages: int,
                      corrupt_last: bool):
        return ReshardFailed(
            f"device-to-device reshard from replica {replica!r} lost "
            f"all {attempts} attempts ({n_pages} pages"
            f"{'; last payload corrupt' if corrupt_last else ''}) — "
            "degrading to host-staged handoff",
            attempts=attempts, pages=n_pages, corrupt=corrupt_last)

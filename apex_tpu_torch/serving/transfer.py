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
:class:`~apex_tpu_torch.serving.health.ReshardFailed`); at the
reference's default the tiles take the host round trip. Over a
tensor-parallel mesh each rank's pool holds its block of the heads
(``serving.decode.shard_tp_cache``): ``make_tile_transfer_fns(mesh)``
gives the gather (the head blocks all-gathered over the mesh's
``model`` group in rank order, then to host arrays) and the shard (this
rank's head block of host tiles), and ``make_reshard_extract_fn(mesh)``
the whole tiles of a page list on the device.

Between processes: a ``PageReshard`` over two meshes of disjoint ranks
(or a channel a router wires between its replicas' processes) sends the
payload from the source ranks (set A) to the destination ranks (set B)
over one group on A and B (:class:`Wire`, made once, at construction,
by every rank). Every rank of the group calls ``ship`` and draws the
same fault sites in the same order: A's ranks extract and gather their
head blocks and take the digest, A's first rank sends the tiles and the
digest to every rank of B, B's ranks apply a drawn corruption to the
bytes they received and check the digest on them, and B's first rank
sends the verdict (delivered or quarantined, and the tiles' bytes) to
every rank. So every rank takes the same branch: the same attempts,
counters, health probes, span and typed error on a lost budget. ``ship``
returns the tiles on B's ranks, ``(None, None, attempts)`` elsewhere; a
rank that does not hold the source passes a host stand-in with the
source's ``page_size`` (``router.RemoteReplica``).

The channel objects are host state (attempt counters, metric handles).
"""

import collections
import hashlib
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from apex_tpu_torch.serving.faults import FaultInjector
from apex_tpu_torch.serving.health import (
    ReshardFailed, ServingStats, TransferCorrupt, TransferFailed,
)
from apex_tpu_torch.serving.observe import Tracer
from apex_tpu_torch.transformer import parallel_state as ps
from apex_tpu_torch.transformer.tensor_parallel import mappings

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


#: a tile's layout over a tensor-parallel mesh: heads (axis 2, as the
#: pool's) split over ``model``
_TILE_SPEC = ps.PartitionSpec(None, None, ps.TENSOR_AXIS)


def _gather_heads(t: torch.Tensor, mesh) -> torch.Tensor:
    """The whole tile from this rank's head block: all-gathered over the
    mesh's ``model`` group in rank order, as raw bytes (each element's
    bytes along the last axis: gloo gathers no 16-bit integers, and a
    byte gather moves any dtype bit for bit)."""
    raw = t.contiguous().view(torch.uint8)
    return ps.gather_leaf(raw, _TILE_SPEC, mesh).view(t.dtype)


def make_tile_transfer_fns(mesh=None, rules=None) -> Tuple[Callable,
                                                           Callable]:
    """``(gather_fn, shard_fn)`` for page tiles over a tensor-parallel
    mesh (the installed one by default), the pool's head axis split over
    ``model``: ``gather_fn(k_tile, v_tile)`` all-gathers this rank's
    head blocks in rank order and returns whole host arrays (bf16 as its
    16-bit bits, as the host round trip's), the same bytes on every
    rank; ``shard_fn(k_tile, v_tile)`` keeps this rank's head block of
    whole host tiles, for the insert into its pool. Hand them to
    :class:`PageTransfer`. ``rules`` is not read: the tile layout is the
    pool's."""
    del rules

    def gather_fn(k_tile, v_tile):
        return (_host(_gather_heads(k_tile, mesh)),
                _host(_gather_heads(v_tile, mesh)))

    def shard_fn(k_tile, v_tile):
        return (ps.shard_leaf(torch.as_tensor(k_tile), _TILE_SPEC, mesh),
                ps.shard_leaf(torch.as_tensor(v_tile), _TILE_SPEC, mesh))

    return gather_fn, shard_fn


def make_reshard_extract_fn(mesh=None) -> Callable:
    """The sender half of the device-to-device reshard: ``(cache,
    page_ids) -> (k_tile, v_tile)``, this rank's head block of the
    identified pages all-gathered over the mesh's ``model`` group in
    rank order (the order the pool lays the heads out in), the whole
    tiles on the device on every rank: bit for bit
    :func:`make_extract_pages_fn` on the gathered cache. Every rank of
    the mesh calls it with the same page ids."""

    def extract(cache, page_ids):
        ids = _ids(cache, page_ids)
        return (_gather_heads(cache.k[:, ids], mesh),
                _gather_heads(cache.v[:, ids], mesh))

    return extract


def _default_gather(k_tile, v_tile):
    return _host(k_tile), _host(v_tile)


def _default_shard(k_tile, v_tile):
    # the insert places host tiles on the receiving pool's device
    return k_tile, v_tile


#: the host tile dtypes a payload header names (bf16 crosses as int16)
_WIRE_DTYPES = (np.float32, np.int16, np.float16, np.int8, np.uint8,
                np.float64)
_HEADER = 8        # int64s: dtype index, ndim, up to six dims
_DIGEST = 32       # sha256


class Wire:
    """The processes of a cross-process handoff and of a router's control
    (the module doc): one process group over ``ranks`` (the default group
    when they are the whole world; else ``new_group``, which every rank
    of the default group calls, in the same order), point-to-point sends
    and broadcasts of host tensors, and ``sent``: the bytes this rank
    sent, by kind (``tiles``, ``digest``, ``header``, ``verdict``,
    ``logits``, ``control``). A CUDA tensor goes to host memory first,
    counted in ``mappings.staged_bytes`` as ``mappings.collective``
    counts it."""

    def __init__(self, ranks: Sequence[int]):
        self.ranks = sorted({int(r) for r in ranks})
        self.rank = dist.get_rank()
        if self.rank not in self.ranks:
            raise ValueError(
                f"rank {self.rank} is not among the handoff's ranks "
                f"{self.ranks}")
        world = dist.get_world_size()
        self.group = dist.group.WORLD \
            if self.ranks == list(range(world)) \
            else dist.new_group(self.ranks)
        self.sent = collections.Counter()

    def send(self, t: torch.Tensor, dst: int, kind: str) -> None:
        """Send ``t`` (to host first) to the global rank ``dst``."""
        nbytes = t.numel() * t.element_size()
        if t.is_cuda:
            mappings.staged_bytes += nbytes
        dist.send(t.detach().contiguous().cpu(), int(dst), group=self.group)
        self.sent[kind] += nbytes

    def recv(self, shape, dtype: torch.dtype, src: int) -> torch.Tensor:
        """A host tensor of ``shape`` and ``dtype`` from rank ``src``."""
        buf = torch.empty(tuple(shape), dtype=dtype)
        dist.recv(buf, int(src), group=self.group)
        return buf

    def share(self, t: torch.Tensor, src: int, kind: str) -> torch.Tensor:
        """Rank ``src``'s ``t`` on every rank of the wire, in host memory
        (one broadcast through ``mappings.collective``); the other ranks
        pass a tensor of the same shape and dtype."""
        x = t.detach().cpu()
        flag = x.dtype == torch.bool
        if flag:
            x = x.to(torch.uint8)
        out = mappings.collective("broadcast", x, self.group, self.ranks,
                                  src=self.ranks.index(int(src)))
        if self.rank == src:
            self.sent[kind] += x.numel() * x.element_size() * (
                len(self.ranks) - 1)
        return out.bool() if flag else out

    def move(self, t: torch.Tensor, src: int, dst: int, device,
             kind: str) -> torch.Tensor:
        """``t`` of rank ``src`` on rank ``dst``, on ``device`` there (a
        copy where ``src`` is ``dst``); the other ranks get their ``t``
        back as it is (a stand-in of the same shape and dtype)."""
        if self.rank == src == dst:
            return t.to(device=device, copy=True)
        if self.rank == src:
            self.send(t, dst, kind)
        elif self.rank == dst:
            out = self.recv(t.shape, t.dtype, src).to(device)
            if out.is_cuda:
                mappings.staged_bytes += out.numel() * out.element_size()
            return out
        return t

    def send_tiles(self, k: np.ndarray, v: np.ndarray, digest: bytes,
                   dst: int) -> None:
        """The payload to ``dst``: a header (dtype and shape), then the k
        bytes, the v bytes and the digest in one message."""
        head = np.zeros(_HEADER, np.int64)
        head[0] = [np.dtype(d) for d in _WIRE_DTYPES].index(k.dtype)
        head[1] = k.ndim
        head[2:2 + k.ndim] = k.shape
        body = np.concatenate([
            np.ascontiguousarray(k).reshape(-1).view(np.uint8),
            np.ascontiguousarray(v).reshape(-1).view(np.uint8),
            np.frombuffer(digest, np.uint8)])
        self.send(torch.from_numpy(head), dst, "header")
        dist.send(torch.from_numpy(body), int(dst), group=self.group)
        self.sent["tiles"] += k.nbytes + v.nbytes
        self.sent["digest"] += len(digest)

    def recv_tiles(self, src: int) -> Tuple[np.ndarray, np.ndarray, bytes]:
        """``(k, v, digest)`` of :meth:`send_tiles` from ``src``."""
        head = self.recv((_HEADER,), torch.int64, src).numpy()
        dtype = np.dtype(_WIRE_DTYPES[int(head[0])])
        shape = tuple(int(d) for d in head[2:2 + int(head[1])])
        n = int(np.prod(shape)) * dtype.itemsize
        body = self.recv((2 * n + _DIGEST,), torch.uint8, src).numpy()
        k = body[:n].view(dtype).reshape(shape)
        v = body[n:2 * n].view(dtype).reshape(shape)
        return k, v, body[2 * n:].tobytes()


def _flip(k_tile: np.ndarray, payload: int) -> np.ndarray:
    """The in-flight corruption: one staged byte flipped, the payload
    picks which (deterministic per seed, site and index); a copy."""
    k_tile = np.array(k_tile, copy=True)
    flat = k_tile.reshape(-1).view(np.uint8)
    flat[payload % flat.size] ^= 0xFF
    return k_tile


def _mesh_ranks(mesh) -> Tuple[int, ...]:
    return tuple(int(r) for r in mesh.ranks.reshape(-1))


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
        #: between processes (the module doc): the :class:`Wire` over
        #: every rank that calls ``ship``, and the ``(source ranks,
        #: destination ranks)`` of the next handoff, fixed by two meshes
        #: or set by the router a handoff (:meth:`connect`)
        self.wire: Optional[Wire] = None
        self.link: Optional[Tuple[Tuple[int, ...], Tuple[int, ...]]] = None
        self._fixed_link = False

    def connect(self, src_ranks: Sequence[int],
                dst_ranks: Sequence[int]) -> None:
        """Point the next handoff from the ranks holding the source to the
        ranks holding the destination. A channel whose two meshes fixed
        its link refuses any other pair of rank sets."""
        link = (tuple(int(r) for r in src_ranks),
                tuple(int(r) for r in dst_ranks))
        if self._fixed_link:
            if link != self.link:
                raise ValueError(
                    f"this channel's meshes join ranks {self.link[0]} -> "
                    f"{self.link[1]}, not {link[0]} -> {link[1]}")
            return
        if set(link[0]) & set(link[1]) and link[0] != link[1]:
            raise ValueError(
                f"a handoff's rank sets must be disjoint or the same, got "
                f"{link[0]} -> {link[1]}")
        self.link = link

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
        when given. Between processes (``wire``) every rank of the wire
        calls it, the tiles come back on the destination's ranks only,
        and ``src_engine`` may be a host stand-in with the source's
        ``page_size`` where this rank does not hold the source."""
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
                if self.wire is None:
                    k_tile, v_tile = self.gather_fn(*self._extract(
                        src_engine.cache, list(src_pages)))
                    digest = transfer_checksum(k_tile, v_tile, chain_key)
                    fired, payload = inj.draw(self.recv_site)
                    if fired:
                        # in-flight corruption of the staged payload
                        k_tile = _flip(k_tile, payload)
                    ok = transfer_checksum(k_tile, v_tile,
                                           chain_key) == digest
                    nbytes = int(k_tile.nbytes) + int(v_tile.nbytes)
                else:
                    k_tile, v_tile, ok, nbytes = self._cross(
                        src_engine, src_pages, chain_key)
                if not ok:
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
                c_bytes.inc(nbytes)
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

    def _cross(self, src_engine, src_pages, chain_key: bytes):
        """One attempt's payload between processes (the module doc):
        ``(k_tile, v_tile, ok, tile bytes)`` on every rank, the tiles on
        the destination's ranks only. Draws the ``recv_site`` on every
        rank."""
        wire = self.wire
        src, dst = self.link
        me = wire.rank
        k_tile = v_tile = digest = None
        if me in src:
            k_tile, v_tile = self.gather_fn(*self._extract(
                src_engine.cache, list(src_pages)))
            if me == src[0] or me in dst:
                digest = transfer_checksum(k_tile, v_tile, chain_key)
            if me == src[0]:
                for r in dst:
                    if r not in src:
                        wire.send_tiles(k_tile, v_tile, digest, r)
        if me in dst and me not in src:
            k_tile, v_tile, digest = wire.recv_tiles(src[0])
        fired, payload = self.injector.draw(self.recv_site)
        verdict = torch.zeros(2, dtype=torch.int64)
        if me in dst:
            if fired:
                # the corruption of the bytes this rank received
                k_tile = _flip(k_tile, payload)
            verdict[0] = int(transfer_checksum(k_tile, v_tile,
                                               chain_key) == digest)
            verdict[1] = int(k_tile.nbytes) + int(v_tile.nbytes)
        else:
            k_tile = v_tile = None
        ok, nbytes = wire.share(verdict, dst[0], "verdict").tolist()
        return k_tile, v_tile, bool(ok), int(nbytes)

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
    pages over its host-staged :class:`PageTransfer`. ``src_mesh`` gathers
    the source pool's head blocks over its ``model`` group,
    ``dst_mesh`` keeps this rank's head block for the receiving pool
    (:func:`make_tile_transfer_fns`). Over the same ranks this process
    is a rank of both. Over disjoint rank sets the channel runs between
    processes (the module doc): the :class:`Wire` over both sets is made
    here, by every rank of the default group, and the link is fixed to
    ``src_mesh``'s ranks -> ``dst_mesh``'s, in mesh order (the first of
    each sends). Sets that overlap otherwise raise ValueError."""

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
        gather_fn, shard_fn = _default_gather, _default_shard
        if src_mesh is not None:
            gather_fn, _ = make_tile_transfer_fns(src_mesh)
        if dst_mesh is not None:
            _, shard_fn = make_tile_transfer_fns(dst_mesh)
        super().__init__(injector=injector, tracer=tracer, stats=stats,
                         max_retries=max_retries, gather_fn=gather_fn,
                         shard_fn=shard_fn)
        if src_mesh is None or dst_mesh is None:
            return
        a, b = _mesh_ranks(src_mesh), _mesh_ranks(dst_mesh)
        if sorted(a) == sorted(b):
            return
        if set(a) & set(b):
            raise ValueError(
                f"PageReshard's meshes must hold the same ranks or "
                f"disjoint ones, got {list(a)} -> {list(b)}")
        if not dist.is_initialized():
            raise RuntimeError(
                f"PageReshard between the ranks {list(a)} and {list(b)} "
                "sends between processes: start torch.distributed's "
                "default process group first")
        self.connect(a, b)
        self._fixed_link = True
        self.wire = Wire(a + b)

    def _budget_error(self, replica: str, attempts: int, n_pages: int,
                      corrupt_last: bool):
        return ReshardFailed(
            f"device-to-device reshard from replica {replica!r} lost "
            f"all {attempts} attempts ({n_pages} pages"
            f"{'; last payload corrupt' if corrupt_last else ''}) — "
            "degrading to host-staged handoff",
            attempts=attempts, pages=n_pages, corrupt=corrupt_last)

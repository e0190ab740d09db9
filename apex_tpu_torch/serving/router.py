"""Disaggregated prefill/decode serving (counterpart of
``apex_tpu/serving/router.py``): prompt forwards on a prefill replica,
decode ticks on a decode replica, the finished prompt pages shipped
between them over the verified
:class:`~apex_tpu_torch.serving.transfer.PageTransfer` channel, keyed
and deduped by the chained content hashes of
:func:`~apex_tpu_torch.serving.paging.prefix_page_keys`.

The :class:`DisaggregatedRouter` IS a
:class:`~apex_tpu_torch.serving.scheduler.ContinuousBatchingScheduler`
whose engine is a composite (:class:`_DisaggEngine`) with the engine
interface. Every decode-path call goes to the ACTIVE replica (the one
whose slots the scheduler drives); only ``prefill`` routes:

1. remote replica routable: run the prompt forward there, ship the
   pages the active pool does not already hold, install them into pages
   the active pool allocated (in the order a local prefill allocates),
   register the prefix chain, return the logits. The slot's cache row
   ends up bit for bit a colocated prefill's (the same kernels on the
   same inputs, the pages copied verbatim), so fault-free routed streams
   are the colocated scheduler's, token for token.
2. remote down, transfer budget exhausted, payload quarantined, or the
   remote pool refused the prompt: a typed error
   (:class:`~apex_tpu_torch.serving.health.TransferFailed` /
   ``TransferCorrupt`` / ``ReplicaUnavailable``), caught here, and the
   admission is served COLOCATED on the active engine (counted in
   ``colocated_prefills``); the request never sees the fault.

Health and failover: the router draws the ``replica_health`` site once a
replica a tick, in a fixed order, and folds the probes into each
replica's :class:`~apex_tpu_torch.serving.health.ReplicaHealth` ladder
with the real transfer and prefill outcomes. A down remote stops
receiving prefills. A down ACTIVE replica triggers failover: every
occupied slot drains to the queue front (the preemption resume path:
re-prefill from prompt plus generated, sampling keys fold the token
count) and the roles swap; the recovered ex-active replica rejoins as
the remote. When no replica is routable the incumbent keeps serving.

Clock: a remote prefill overlaps the active replica's decode ticks, so
the router charges the deterministic handoff cost
(``handoff_ticks_per_page`` a shipped page, at least one control tick,
plus ``backoff_ticks`` a retried attempt, observed in the
``serving_transfer_ticks`` histogram) instead of the prompt's depth.
Sampling keys never see the clock.

Scope: every replica is a PAGED engine with the same model and geometry
and the SAME injector, tracer and host tier (or none). Chunked prefill,
model drafters, tree speculation and int8 pools stay colocated; the
constructors refuse them, typed.

:class:`PoolRouter` generalizes the pair to N prefill x M decode
replicas behind one admission queue. Prefill admissions route by load
(health rung, link ticks routed this pass, the admitting tenant's last
replica, pages free, fixed order; a fired ``pool_route`` draw degrades
the pick to fixed order). One decode replica backs the slots; failover
walks decode sibling -> borrowed prefill replica -> last replica
standing, and the slots move home once a decode replica recovers
(``rebalance``). Handoffs try the device-to-device
:class:`~apex_tpu_torch.serving.transfer.PageReshard` first, priced a
page at ``ici_ticks_per_page`` within a slice of ``placement`` and
``dcn_ticks_per_page`` across, and re-ship host-staged on
:class:`~apex_tpu_torch.serving.health.ReshardFailed`. Handoffs routed
to distinct prefill replicas in one pass overlap: the pass is charged
the busy horizon's increase, not the sum.

On one card every replica's kernels share per-device state: the split
paged kernels' arrival counters and work buffer
(``transformer.functional.paged_attention``) and the w8 kernels' split-K
counters. Replicas on one device are safe because the router runs them
one after another on one stream; it starts no second stream.

Replicas in separate processes: a replica is one rank (its engine is
single-device). On a rank that does not hold a replica, the router is
given a :class:`RemoteReplica` in its place: the replica's host half
(page pool, prefix registry, block-table and length rows in host
memory, the same fault draws and tracer spans) with no params, no pages
and no forward. Every rank of the pool runs the router's whole host
control (admission, routing, the work clock, the health ladders, the
injector, every replica's bookkeeping), so the control state is the
same on every rank; the device work runs on the replica's rank only.
What the control reads from a forward it did not run is broadcast from
the rank that ran it over one :class:`~apex_tpu_torch.serving.transfer.
Wire` on every rank of the pool: the finite-row flags and the sampled
tokens (``finite``, ``sample``, ``sample_grid`` of the active replica).
A remote prefill's last logits row hops from the prefill replica's rank
to the active replica's after its pages (``logits``), and the handoff
channels send the verified pages between the two ranks (the transfer
module doc). Failover needs no state move: the drained slots re-prefill
on the target replica. A host tier stays in one process.

This module is host state (router bookkeeping, health ladders).
"""

from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from apex_tpu_torch.serving.cache import (
    NULL_PAGE, SCRATCH_PAGE, PagedKVCache, max_pages_per_slot,
)
from apex_tpu_torch.serving.faults import FaultInjector, InjectedFault
from apex_tpu_torch.serving.health import (
    HEALTH_STATES, PoolExhausted, ReplicaHealth, ReplicaUnavailable,
    ReshardFailed, TransferCorrupt, TransferFailed,
)
from apex_tpu_torch.serving.observe import Tracer
from apex_tpu_torch.serving.scheduler import (
    ContinuousBatchingScheduler, PagedDecodeEngine,
)
from apex_tpu_torch.serving.transfer import (
    PageReshard, PageTransfer, Wire, make_insert_pages_fn,
)

#: The remote replica prefills every admission into this slot and frees
#: it once the pages shipped: admissions are sequential, so one staging
#: slot is enough, and the remote's prefix registry (not its slots)
#: carries its dedup across requests.
_STAGING_SLOT = 0

#: The pair's fixed health-probe order (initial role names: replay
#: depends on the draw ORDER, not on which replica serves).
_REPLICA_ORDER = ("prefill", "decode")

#: Engine attributes every replica of a pool must agree on: the page
#: geometry the handoff relies on, and everything that shapes a
#: committed stream.
_PAIRED_ATTRS = ("cfg", "num_slots", "max_len", "page_size", "buckets",
                 "spec_k", "top_k", "top_p", "adaptive_spec",
                 "prefix_sharing")


def _rows(*lead: int, vocab: int) -> torch.Tensor:
    """A stand-in for logits a forward on another rank computed: their
    shape and dtype, no data (the meta device)."""
    return torch.empty(tuple(lead) + (vocab,), dtype=torch.float32,
                       device="meta")


class RemoteReplica(PagedDecodeEngine):
    """The host half of a paged replica whose engine lives on the rank
    ``rank`` (the module doc): give it to a router on every other rank
    of the pool, built with the replica's own arguments (the
    :class:`~apex_tpu_torch.serving.scheduler.PagedDecodeEngine`'s, less
    the params, the compute dtype, the drafter, the host tier and the
    device) and the pool's one injector and tracer. It keeps the page
    pool, the prefix registry and the block-table and length rows in
    host memory, draws the fault sites and opens the tracer spans the
    engine does, and runs no forward: a step gives logits on the meta
    device, and ``finite`` / ``sample`` / ``sample_grid`` give
    placeholders the router replaces with the holder's broadcast."""

    def __init__(self, rank: int, cfg, num_slots: int, max_len: int,
                 num_pages: int, page_size: int,
                 cache_dtype: torch.dtype = torch.bfloat16, top_k: int = 0,
                 top_p: float = 0.0, spec_k: int = 0,
                 buckets: Optional[Sequence[int]] = None,
                 free_order: Optional[Sequence[int]] = None,
                 prefix_sharing: bool = True,
                 injector: Optional[FaultInjector] = None,
                 adaptive_spec: bool = False,
                 tracer: Optional[Tracer] = None):
        self.rank = int(rank)
        super().__init__({}, cfg, num_slots, max_len, num_pages,
                         page_size, cache_dtype=cache_dtype, top_k=top_k,
                         top_p=top_p, spec_k=spec_k, buckets=buckets,
                         free_order=free_order,
                         prefix_sharing=prefix_sharing, injector=injector,
                         adaptive_spec=adaptive_spec, tracer=tracer,
                         device="cpu")

    def _make_cache(self, num_pages: int,
                    cache_dtype: torch.dtype) -> PagedKVCache:
        cfg = self.cfg
        shape = (cfg.num_layers, num_pages, cfg.num_heads, self.page_size,
                 cfg.head_dim)
        # the pages' shape and dtype on the meta device: no memory
        k, v = (torch.empty(shape, dtype=cache_dtype, device="meta")
                for _ in range(2))
        scales = (None, None)
        if cache_dtype == torch.int8:
            scales = tuple(torch.empty(shape[:3], device="meta")
                           for _ in range(2))
        bt = torch.full((self.num_slots, max_pages_per_slot(
            self.max_len, self.page_size)), SCRATCH_PAGE, dtype=torch.int32)
        lengths = torch.zeros((self.num_slots,), dtype=torch.int32)
        return PagedKVCache(k, v, lengths, bt, *scales)

    def _make_steps(self, compute_dtype, quantized) -> None:
        vocab = self.cfg.vocab_size

        # each step writes what the holder's step writes into the
        # replica's host rows (the audit reads the block tables)
        def prefill(params, cache, ids, mask, slot, write, row):
            cache.lengths[int(slot)] = int(mask.sum())
            cache.block_tables[int(slot)] = row.to(torch.int32)
            return cache, _rows(1, vocab=vocab)

        def decode(params, cache, tokens, active):
            pos = cache.lengths
            cache.lengths.copy_(torch.where(active, pos + 1, pos))
            return cache, _rows(tokens.shape[0], vocab=vocab)

        def verify(params, cache, tokens):
            return cache, _rows(*tokens.shape, vocab=vocab)

        self._prefill = prefill
        self._decode = decode
        self._verify = verify
        # chunked prefill, the host tier and tree speculation stay
        # colocated (the routers refuse them)
        self._chunk_prefill = self._tree_verify = None
        self._copy = lambda cache, src, dst: cache

    def finite(self, logits: torch.Tensor) -> torch.Tensor:
        return torch.ones(logits.shape[:-1], dtype=torch.bool)

    def sample(self, logits, keys, temperature) -> torch.Tensor:
        # the holder's ``sample`` site draw, on this rank's injector
        return self._bad_sample(torch.zeros(logits.shape[:-1],
                                            dtype=torch.int32))

    sample_grid = sample


def _owners(named) -> Optional[Dict[str, int]]:
    """Replica name -> the rank holding it, when any replica is a
    :class:`RemoteReplica` (this rank holds the engines it was given);
    None for a pool in one process."""
    if not any(isinstance(e, RemoteReplica) for _, e in named):
        return None
    me = dist.get_rank()
    return {name: e.rank if isinstance(e, RemoteReplica) else me
            for name, e in named}


def _pool_wire(owners: Dict[str, int], channels) -> Wire:
    """The wire over every rank of the pool, shared with the handoff
    channels (a channel two meshes wired must span the same ranks);
    every rank checks that all of them place the replicas alike."""
    ranks = sorted(set(owners.values()))
    wire = next((c.wire for c in channels
                 if c is not None and c.wire is not None), None)
    if wire is None:
        wire = Wire(ranks)
    elif wire.ranks != ranks:
        raise ValueError(
            f"the handoff channel's ranks {wire.ranks} are not the pool's "
            f"{ranks}")
    for c in channels:
        if c is not None:
            c.wire = wire
    seen = [None] * len(wire.ranks)
    dist.all_gather_object(seen, owners, group=wire.group)
    if any(o != owners for o in seen):
        raise ValueError(
            "the ranks of the pool place its replicas differently: "
            f"{dict(zip(wire.ranks, seen))}")
    return wire


def _as_pool(engines) -> List:
    """An engine or a sequence of engines, as a list."""
    if isinstance(engines, (list, tuple)):
        return list(engines)
    return [engines]


def _pool_names(n_prefill: int, n_decode: int):
    """Replica names by role and index: the 1x1 pair keeps the bare
    ``prefill`` / ``decode`` (metric labels and replays use them), a
    pool indexes them (``prefill0`` ...)."""
    if n_prefill == 1 and n_decode == 1:
        return ("prefill",), ("decode",)
    return (tuple(f"prefill{i}" for i in range(n_prefill)),
            tuple(f"decode{i}" for i in range(n_decode)))


def _validate_replicas(prefill_engines, decode_engines) -> None:
    """The pairing contract over ALL N + M replicas: each a distinct
    paged engine, every attribute of :data:`_PAIRED_ATTRS` the first
    replica's, and ONE host tier, injector and tracer pool-wide (a
    per-pair check would admit a pool whose halves fork the prefix
    namespace or the fault-draw sequence)."""
    prefills = _as_pool(prefill_engines)
    decodes = _as_pool(decode_engines)
    if not prefills or not decodes:
        raise ValueError(
            "a replica pool needs at least one prefill and one decode "
            "engine")
    pnames, dnames = _pool_names(len(prefills), len(decodes))
    named = list(zip(pnames, prefills)) + list(zip(dnames, decodes))
    engines = [e for _, e in named]
    if len({id(e) for e in engines}) != len(engines):
        raise ValueError(
            "disaggregation needs two engine instances per pair: every "
            "pool replica must be a DISTINCT engine (a shared instance "
            "would alias slots and page pools)")
    for role, eng in named:
        if not getattr(eng, "paged", False):
            raise ValueError(
                f"the {role} replica must be a paged engine: the "
                "handoff ships page tiles keyed by prefix_page_keys")
        if getattr(eng.cache, "k_scale", None) is not None:
            raise ValueError(
                "disaggregated serving is not offered over the int8 "
                "page pool: shipped pages would carry page-local "
                "scales quantized against the SENDER's amax sweep; "
                "kv8 keeps colocated serving")
        if eng.draft_model is not None or eng.tree_spec:
            raise ValueError(
                "model drafters / tree speculation stay colocated: "
                "the drafter's lockstep cache would need its own "
                "cross-replica handoff (n-gram spec_k works "
                "disaggregated)")
    ref_name, ref = named[0]
    for attr in _PAIRED_ATTRS:
        for name, eng in named[1:]:
            va, vb = getattr(ref, attr), getattr(eng, attr)
            if va != vb:
                raise ValueError(
                    f"disaggregated replicas must agree on {attr}: "
                    f"{ref_name}={va!r} vs {name}={vb!r}")
    if len({id(eng.host_tier) for eng in engines}) > 1:
        raise ValueError(
            "all replicas must share ONE PrefixRegistry host tier "
            "(or none of them): the registry is the global content-"
            "addressed map — split tiers would fork the prefix "
            "namespace (construct every engine with the same "
            "host_tier=)")
    if len({id(eng.injector) for eng in engines}) > 1:
        raise ValueError(
            "all replicas must share ONE FaultInjector: fault draws "
            "form a single deterministic sequence (construct every "
            "engine with the same injector=)")
    if len({id(eng.tracer) for eng in engines}) > 1:
        raise ValueError(
            "all replicas must share ONE Tracer: events, metrics and "
            "the stats view live in a single registry (construct "
            "every engine with the same tracer=)")


class _DisaggEngine:
    """The composite engine of :class:`DisaggregatedRouter`: the engine
    interface over two paged replicas. Attribute access falls through
    to the ACTIVE replica; ``prefill`` routes (see the module doc);
    :meth:`switch_active` swaps the roles on failover."""

    paged = True

    def __init__(self, prefill_engine, decode_engine,
                 transfer: PageTransfer,
                 health: Dict[str, ReplicaHealth],
                 handoff_ticks_per_page: float,
                 backoff_ticks: int,
                 owners: Optional[Dict[str, int]] = None,
                 wire: Optional[Wire] = None):
        # the delegation table first: __getattr__ reads it
        self._replicas = {"prefill": prefill_engine,
                          "decode": decode_engine}
        self.owners = owners
        self.wire = wire
        self._active_name = "decode"
        self._remote_name = "prefill"
        self._order = _REPLICA_ORDER
        self.transfer = transfer
        self.health = health
        self.handoff_ticks_per_page = float(handoff_ticks_per_page)
        self.backoff_ticks = int(backoff_ticks)
        self.injector = decode_engine.injector
        self.tracer = decode_engine.tracer
        self.stats = decode_engine.stats
        self._insert = make_insert_pages_fn()
        self._admit_charge: Optional[int] = None

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        return getattr(self.__dict__["_replicas"][
            self.__dict__["_active_name"]], name)

    @property
    def active(self):
        return self._replicas[self._active_name]

    @property
    def remote(self):
        return self._replicas[self._remote_name]

    @property
    def active_name(self) -> str:
        return self._active_name

    @property
    def remote_name(self) -> str:
        return self._remote_name

    # -- health / failover ----------------------------------------------

    def health_tick(self) -> None:
        """One ``replica_health`` probe a replica, in the fixed order
        ``self._order`` (never the current roles), at the top of every
        admission pass: the draw indices are a function of the tick
        count and the pool's shape alone."""
        for name in self._order:
            fired, _ = self.injector.draw("replica_health")
            self.health[name].probe(not fired)

    @property
    def active_down(self) -> bool:
        return not self.health[self._active_name].routable

    @property
    def remote_routable(self) -> bool:
        return self.health[self._remote_name].routable

    def switch_active(self) -> None:
        self._active_name, self._remote_name = (self._remote_name,
                                                self._active_name)

    # -- what the control reads from a forward ---------------------------

    def _share(self, out: torch.Tensor) -> torch.Tensor:
        """``out`` of the active replica's rank on every rank (the module
        doc); itself in one process."""
        if self.wire is None:
            return out
        return self.wire.share(out, self.owners[self._active_name],
                               "control")

    def finite(self, logits: torch.Tensor) -> torch.Tensor:
        return self._share(self.active.finite(logits))

    def sample(self, logits: torch.Tensor, keys,
               temperature: Sequence[float]) -> torch.Tensor:
        return self._share(self.active.sample(logits, keys, temperature))

    def sample_grid(self, logits: torch.Tensor, keys,
                    temperature: Sequence[float]) -> torch.Tensor:
        return self._share(self.active.sample_grid(logits, keys,
                                                   temperature))

    def _connect(self, tier: PageTransfer, rname: str) -> None:
        """Point ``tier``'s next handoff from ``rname``'s rank to the
        active replica's (between processes only)."""
        if self.wire is not None:
            tier.connect((self.owners[rname],),
                         (self.owners[self._active_name],))

    # -- the admission charge -------------------------------------------

    def pop_admit_charge(self, default: int) -> int:
        # a remote prefill staged its handoff (and promote) ticks here; a
        # colocated one staged on the active engine, which reprices it
        charge, self._admit_charge = self._admit_charge, None
        if charge is not None:
            return charge
        return self.active.pop_admit_charge(default)

    # -- routed prefill -------------------------------------------------

    def prefill(self, slot: int, prompt: Sequence[int]) -> torch.Tensor:
        trc = self.tracer
        if self.remote_routable:
            try:
                return self._remote_prefill(slot, prompt,
                                            self._remote_name)
            except (TransferFailed, TransferCorrupt,
                    ReplicaUnavailable) as e:
                # degrade, don't fail: served colocated, the request
                # never sees the transfer or replica fault
                if trc.enabled:
                    trc.instant("failover", slot=slot,
                                cause=type(e).__name__,
                                replica=self._remote_name)
        self.stats.colocated_prefills += 1
        return self.active.prefill(slot, prompt)

    def _remote_prefill(self, slot: int, prompt: Sequence[int],
                        rname: str) -> torch.Tensor:
        act, rem = self.active, self._replicas[rname]
        rhealth = self.health[rname]
        toks = [int(t) for t in prompt]
        try:
            logits = rem.prefill(_STAGING_SLOT, toks)
        except PoolExhausted as e:
            # remote CAPACITY, not a remote failure: no health demerit
            raise ReplicaUnavailable(
                f"remote replica {rname!r} page pool "
                f"refused the prompt: {e}",
                replica=rname) from e
        except InjectedFault:
            # a transient fault on the remote: it rolled its pages back;
            # the scheduler charges the retry budget as for a colocated
            # prefill fault, and repeated faults walk the replica down
            rhealth.probe(False)
            raise
        # the remote staged its own admission repricing; the router
        # charges handoff ticks instead
        rem.pop_admit_charge(0)
        # the destination pages in the order a colocated prefill claims
        # them: the shared prefix run, host-tier promotions, then fresh
        # pages, all or nothing
        try:
            _, keys, pages, covered, promote_ticks = act._claim_pages(
                slot, toks)
        except PoolExhausted:
            rem.free_slot(_STAGING_SLOT)
            raise
        n_pages = len(pages)
        private = pages[covered:]
        src_pages = rem._slot_pages[_STAGING_SLOT][covered:n_pages]
        self.stats.transfer_pages_deduped += covered
        try:
            k_tile, v_tile, attempts, tpp, tier = self._ship_pages(
                rem, toks, src_pages, rname, rhealth)
        except (TransferFailed, TransferCorrupt):
            for q in pages:
                act.pool.release(q)
            act._slot_pages[slot] = []
            rem.free_slot(_STAGING_SLOT)
            raise
        # install: the block-table row (NULL past the prompt's pages) and
        # the true prompt length, what the colocated prefill writes; then
        # the verified tiles into the private pages
        row = np.full((act.max_pages,), NULL_PAGE, np.int32)
        row[:n_pages] = pages
        act.cache.block_tables[slot] = torch.as_tensor(
            row, device=act.cache.block_tables.device)
        act.cache.lengths[slot] = len(toks)
        if private and k_tile is not None:
            # (between processes the tiles reach the active's rank only)
            k_dev, v_dev = tier.shard_fn(k_tile, v_tile)
            act.cache = self._insert(act.cache, private, k_dev, v_dev)
        if act.prefix_sharing:
            act.pool.register_prefix(keys, pages)
        rem.free_slot(_STAGING_SLOT)
        self.stats.remote_prefills += 1
        ticks = self._handoff_ticks(len(private), attempts, tpp)
        self._stage_charge(ticks, promote_ticks, rname)
        tier.observe_ticks(rname, ticks + promote_ticks)
        # the logits row hops replicas with the pages, its bits kept
        if self.wire is None:
            return logits.to(device=act.device, copy=True)
        return self.wire.move(logits, self.owners[rname],
                              self.owners[self._active_name], act.device,
                              "logits")

    def _ship_pages(self, rem, toks, src_pages, rname: str, rhealth):
        """Move the private pages over the channel; returns ``(k_tile,
        v_tile, attempts, ticks_per_page, tier)``. The pool engine
        tries the device-to-device reshard first."""
        self._connect(self.transfer, rname)
        k_tile, v_tile, attempts = self.transfer.ship(
            rem, toks, src_pages, replica=rname, health=rhealth)
        return (k_tile, v_tile, attempts, self.handoff_ticks_per_page,
                self.transfer)

    def _handoff_ticks(self, shipped_pages: int, attempts: int,
                       tpp: Optional[float] = None) -> int:
        """The tick cost of a delivered handoff: the shipped pages at
        ``tpp`` ticks a page (``handoff_ticks_per_page`` by default), at
        least one control tick, plus one backoff tick a failed
        attempt."""
        if tpp is None:
            tpp = self.handoff_ticks_per_page
        moved = int(np.ceil(shipped_pages * tpp))
        return max(1, moved) + (attempts - 1) * self.backoff_ticks

    def _stage_charge(self, ticks: int, promote_ticks: int,
                      rname: str) -> None:
        """Stage the admission's clock charge for
        :meth:`pop_admit_charge`: the pair charges the handoff serially
        (the pool engine overlaps distinct links)."""
        self._admit_charge = ticks + promote_ticks

    # -- audit / diagnostics over both replicas -------------------------

    def check_invariants(self) -> bool:
        self.active.check_invariants()
        self.remote.check_invariants()
        return True

    def pool_snapshot(self) -> Dict:
        return {"active": {"replica": self._active_name,
                           **self.active.pool_snapshot()},
                "remote": {"replica": self._remote_name,
                           **self.remote.pool_snapshot()}}

    def pool_gauges(self) -> Dict[str, float]:
        # the tick gauges follow the pool the slots live in; the remote
        # pool's story is told by the per-replica transfer metrics
        return self.active.pool_gauges()


class _PoolEngine(_DisaggEngine):
    """The N x M composite of :class:`PoolRouter` (see the module doc):
    one decode replica ACTIVE, its siblings failover targets picked by
    pages-free headroom, prefill admissions routed by load, handoffs
    over the reshard tier first, the admission clock charged by the
    link-overlap model (with one prefill replica exactly the pair's
    serial charge)."""

    def __init__(self, prefills: Sequence, decodes: Sequence,
                 transfer: PageTransfer,
                 reshard: Optional[PageReshard],
                 handoff_ticks_per_page: float,
                 ici_ticks_per_page: float,
                 dcn_ticks_per_page: float,
                 backoff_ticks: int,
                 recover_after: int,
                 placement: Optional[Mapping[str, int]],
                 owners: Optional[Dict[str, int]] = None,
                 wire: Optional[Wire] = None):
        # the delegation table first (__getattr__ reads it)
        pnames, dnames = _pool_names(len(prefills), len(decodes))
        self._replicas = dict(zip(pnames + dnames,
                                  list(prefills) + list(decodes)))
        self.owners = owners
        self.wire = wire
        self.prefill_names = pnames
        self.decode_names = dnames
        self._order = pnames + dnames
        self._active_name = dnames[0]
        # the base class's remote; pool routing picks per admission
        self._remote_name = pnames[0]
        self.transfer = transfer
        self.reshard = reshard
        self.handoff_ticks_per_page = float(handoff_ticks_per_page)
        self.ici_ticks_per_page = float(ici_ticks_per_page)
        self.dcn_ticks_per_page = float(dcn_ticks_per_page)
        self.backoff_ticks = int(backoff_ticks)
        self.placement = dict(placement or {})
        eng0 = self._replicas[self._active_name]
        self.injector = eng0.injector
        self.tracer = eng0.tracer
        self.stats = eng0.stats
        self.health = {
            name: ReplicaHealth(name, registry=self.tracer.registry,
                                recover_after=recover_after)
            for name in self._order}
        self._insert = make_insert_pages_fn()
        self._admit_charge: Optional[int] = None
        self._pass_busy: Dict[str, int] = {}
        self._route_hot: Dict[str, object] = {}
        self._load_hot: Dict[str, object] = {}
        # the prefill replica each tenant was last routed to: the
        # routing key's affinity tiebreak (prefix locality), read only
        # when the scheduler stamps admission_tenant (tenancy on)
        self._tenant_affinity: Dict[str, str] = {}

    # -- pool observability ---------------------------------------------

    def _route_mark(self, reason: str) -> None:
        c = self._route_hot.get(reason)
        if c is None:
            c = self._route_hot[reason] = self.tracer.registry.counter(
                "serving_pool_routing_total",
                help="prefill routing decisions by reason (load = "
                     "least-loaded pick, fallback = pool_route fault "
                     "degraded to fixed order, colocated = no "
                     "routable prefill replica, degraded = "
                     "transfer/replica fault forced colocated)",
                labels={"reason": reason})
        c.inc()

    def _load_gauge(self, name: str):
        g = self._load_hot.get(name)
        if g is None:
            g = self._load_hot[name] = self.tracer.registry.gauge(
                "serving_pool_replica_load",
                help="link ticks routed to this prefill replica in "
                     "the current admission pass (the routing score's "
                     "queue-depth term)",
                labels={"replica": name})
        return g

    # -- admission pass state -------------------------------------------

    def begin_admission_pass(self) -> None:
        """Reset the pass's link-busy horizon; the router calls it at
        the top of every admission pass, before the health probes."""
        self._pass_busy.clear()
        for name in self.prefill_names:
            self._load_gauge(name).set(0.0)

    # -- load-based prefill routing -------------------------------------

    def _load_key(self, name: str):
        """The routing key, lower first: health rung (healthy before
        degraded), link ticks routed to the replica this pass, the
        admitting tenant's affinity (a constant without tenancy), pages
        free, fixed order. Placement may move with tenancy; committed
        tokens do not."""
        tenant = self.admission_tenant
        affine = 0 if (tenant is not None
                       and self._tenant_affinity.get(tenant) == name) \
            else 1
        return (-HEALTH_STATES.index(self.health[name].state),
                self._pass_busy.get(name, 0),
                affine,
                -self._replicas[name].pool.num_free,
                self._order.index(name))

    def _note_route(self, name: str) -> str:
        """Record the pick as the admitting tenant's affinity; returns
        it."""
        tenant = self.admission_tenant
        if tenant is not None:
            self._tenant_affinity[tenant] = name
        return name

    def _route_prefill(self) -> Optional[str]:
        """The prefill replica of one remote admission, or None to serve
        colocated. One ``pool_route`` draw a remote admission: a fired
        draw degrades the pick to the FIRST routable replica in fixed
        order."""
        cands = [n for n in self.prefill_names
                 if n != self._active_name and self.health[n].routable]
        if not cands:
            self._route_mark("colocated")
            return None
        for n in cands:
            self._load_gauge(n).set(self._pass_busy.get(n, 0))
        fired, _ = self.injector.draw("pool_route")
        if fired:
            self.stats.route_fallbacks += 1
            self._route_mark("fallback")
            return self._note_route(cands[0])
        self._route_mark("load")
        return self._note_route(min(cands, key=self._load_key))

    def prefill(self, slot: int, prompt: Sequence[int]) -> torch.Tensor:
        trc = self.tracer
        rname = self._route_prefill()
        if rname is not None:
            try:
                return self._remote_prefill(slot, prompt, rname)
            except (TransferFailed, TransferCorrupt,
                    ReplicaUnavailable) as e:
                # degrade, don't fail: the pair's ladder
                if trc.enabled:
                    trc.instant("failover", slot=slot,
                                cause=type(e).__name__, replica=rname)
                self._route_mark("degraded")
        self.stats.colocated_prefills += 1
        return self.active.prefill(slot, prompt)

    # -- two-tier handoff -----------------------------------------------

    def _link_tpp(self, rname: str) -> float:
        """Ticks a page on the (source, active) link: the same slice of
        ``placement`` rides the ICI rate, another slice the DCN rate; no
        reshard channel, the host-staged rate."""
        if self.reshard is None:
            return self.handoff_ticks_per_page
        src = self.placement.get(rname, 0)
        dst = self.placement.get(self._active_name, 0)
        return (self.ici_ticks_per_page if src == dst
                else self.dcn_ticks_per_page)

    def _ship_pages(self, rem, toks, src_pages, rname: str, rhealth):
        if self.reshard is None:
            return super()._ship_pages(rem, toks, src_pages, rname,
                                       rhealth)
        try:
            self._connect(self.reshard, rname)
            k_tile, v_tile, attempts = self.reshard.ship(
                rem, toks, src_pages, replica=rname, health=rhealth)
            return (k_tile, v_tile, attempts, self._link_tpp(rname),
                    self.reshard)
        except ReshardFailed as e:
            # the device-to-device link lost its budget: re-ship
            # host-staged, the burned attempts carried into the backoff
            # charge; a host-staged exhaustion then propagates and the
            # admission falls back colocated
            if self.tracer.enabled:
                self.tracer.instant("failover", cause="ReshardFailed",
                                    replica=rname, tier="host_staged",
                                    corrupt=e.corrupt)
            burned = e.attempts
        self._connect(self.transfer, rname)
        k_tile, v_tile, attempts = self.transfer.ship(
            rem, toks, src_pages, replica=rname, health=rhealth)
        return (k_tile, v_tile, burned + attempts,
                self.handoff_ticks_per_page, self.transfer)

    # -- link-overlap clock charging ------------------------------------

    def _stage_charge(self, ticks: int, promote_ticks: int,
                      rname: str) -> None:
        """Charge the admission the INCREASE of the pass's link-busy
        horizon: handoffs from distinct prefill replicas in one pass
        overlap, so only the critical path costs ticks. At least one
        control tick an admission; promote ticks are active-engine work
        and stay serial."""
        old_h = max(self._pass_busy.values(), default=0)
        self._pass_busy[rname] = self._pass_busy.get(rname, 0) + ticks
        new_h = max(self._pass_busy.values())
        self._admit_charge = max(1, new_h - old_h) + promote_ticks
        self._load_gauge(rname).set(self._pass_busy[rname])

    # -- N-way failover / placement -------------------------------------

    @property
    def active_borrowed(self) -> bool:
        """A prefill replica serves as the active decode engine (the
        ladder's last rung before last replica standing)."""
        return self._active_name in self.prefill_names

    def pick_active_target(self) -> Optional[str]:
        """Where the slots move when the active replica goes down: the
        routable replica with the most pages free, decode siblings
        before prefill borrows, fixed order breaking ties; None when
        nobody is routable (the incumbent keeps serving)."""
        cands = [n for n in self._order
                 if n != self._active_name and self.health[n].routable]
        if not cands:
            return None
        return max(cands, key=lambda n: (n in self.decode_names,
                                         self._replicas[n].pool.num_free,
                                         -self._order.index(n)))

    def pick_home_decode(self) -> Optional[str]:
        """The decode replica to move back onto once one is routable
        again (asked only while the active is a borrowed prefill
        replica)."""
        cands = [n for n in self.decode_names
                 if n != self._active_name and self.health[n].routable]
        if not cands:
            return None
        return max(cands, key=lambda n: (self._replicas[n].pool.num_free,
                                         -self._order.index(n)))

    def set_active(self, name: str) -> None:
        """Move the decode placement (the router drained the slots
        first); every move is a ``rebalance`` instant and counts in
        ``stats.rebalances``."""
        old = self._active_name
        self._active_name = name
        self.stats.rebalances += 1
        if self.tracer.enabled:
            self.tracer.instant("rebalance", replica=old, target=name)

    # -- audit over the whole pool --------------------------------------

    def check_invariants(self) -> bool:
        for eng in self._replicas.values():
            eng.check_invariants()
        return True

    def pool_snapshot(self) -> Dict:
        return {name: {"active": name == self._active_name,
                       **eng.pool_snapshot()}
                for name, eng in self._replicas.items()}


def _preempt_drain(router, cause: str) -> int:
    """Drain every occupied slot to the queue FRONT in submission order
    (the preemption resume path: the committed streams continue bit for
    bit) and free the slots on the CURRENT active replica; the pair's
    failover and the pool's moves share it. Returns the slots
    drained."""
    eng = router.engine
    trc = router.tracer
    old = eng.active
    occupied = [(i, s) for i, s in enumerate(router._slots)
                if s is not None]
    for i, s in sorted(occupied, key=lambda t: t[1].request_id,
                       reverse=True):
        if trc.enabled:
            trc.instant("preempted", request_id=s.request_id,
                        slot=i, cause=cause)
        router._queue.appendleft((s.request_id, s.request,
                                  list(s.generated)))
        router._slots[i] = None
        old.free_slot(i)
    return len(occupied)


class DisaggregatedRouter(ContinuousBatchingScheduler):
    """The two-replica serving tier (see the module doc): a
    ``ContinuousBatchingScheduler`` over a :class:`_DisaggEngine`, with
    health probes every tick and failover.

    ``transfer_max_retries`` bounds a handoff's re-attempts;
    ``handoff_ticks_per_page`` and ``backoff_ticks`` price a delivered
    handoff on the tick clock; ``recover_after`` is each replica's run
    of clean probes a step up the health ladder. The other keywords are
    the base scheduler's (``chunk_tokens`` refused: chunked prefill
    stays colocated)."""

    def __init__(self, prefill_engine, decode_engine, eos_id: int, *,
                 transfer_max_retries: int = 2,
                 handoff_ticks_per_page: float = 0.125,
                 backoff_ticks: int = 1,
                 recover_after: int = 2,
                 transfer: Optional[PageTransfer] = None,
                 **kwargs):
        _validate_replicas(prefill_engine, decode_engine)
        if kwargs.get("chunk_tokens") is not None:
            raise ValueError(
                "chunked prefill stays colocated: the disaggregated "
                "router runs monolithic admission prefill on the "
                "remote replica (the chunks would serialize against "
                "the very decode ticks disaggregation unblocks)")
        tracer = decode_engine.tracer
        registry = tracer.registry
        health = {name: ReplicaHealth(name, registry=registry,
                                      recover_after=recover_after)
                  for name in _REPLICA_ORDER}
        if transfer is None:
            transfer = PageTransfer(injector=decode_engine.injector,
                                    tracer=tracer,
                                    stats=decode_engine.stats,
                                    max_retries=transfer_max_retries)
        owners = _owners([("prefill", prefill_engine),
                          ("decode", decode_engine)])
        wire = None if owners is None else _pool_wire(owners, [transfer])
        engine = _DisaggEngine(prefill_engine, decode_engine, transfer,
                               health, handoff_ticks_per_page,
                               backoff_ticks, owners, wire)
        super().__init__(engine, eos_id, **kwargs)

    @property
    def health(self) -> Dict[str, ReplicaHealth]:
        return self.engine.health

    def _admit(self) -> None:
        eng = self.engine
        eng.health_tick()
        if eng.active_down and eng.remote_routable:
            self._failover()
        super()._admit()

    def _failover(self) -> None:
        """The ACTIVE replica went down: drain the occupied slots to the
        queue front and swap the roles; admission goes on this tick on
        the survivor. With both replicas down the incumbent keeps
        serving (health gates routing, not survival)."""
        eng = self.engine
        trc = self.tracer
        if trc.enabled:
            trc.instant("failover",
                        slots=sum(s is not None for s in self._slots),
                        replica=eng.active_name)
        _preempt_drain(self, "failover")
        eng.switch_active()
        self.stats.failovers += 1


class PoolRouter(ContinuousBatchingScheduler):
    """The pool serving tier: N prefill x M decode replicas behind ONE
    admission queue (see the module doc), a
    ``ContinuousBatchingScheduler`` over a :class:`_PoolEngine`.

    ``prefill_engines`` / ``decode_engines`` are sequences of paged
    engines (a bare engine is a pool of one); every replica shares one
    injector, one tracer and one host tier (or none), with the same
    geometry, checked across the whole pool. ``placement`` maps a
    replica name (``prefill0`` ... / ``decode0`` ...; the 1x1 pool keeps
    ``prefill`` / ``decode``) to a mesh slice id, 0 where unmapped.
    ``use_reshard=False`` pins the pool to host staging.

    Committed streams are the 1x1 :class:`DisaggregatedRouter`'s (and
    the colocated scheduler's) through every routing, reshard, failover
    and fault path: placement never touches a sampling key, drains
    resume bit for bit, and the fault ladders move only WHERE work
    runs."""

    def __init__(self, prefill_engines, decode_engines, eos_id: int, *,
                 transfer_max_retries: int = 2,
                 handoff_ticks_per_page: float = 0.125,
                 ici_ticks_per_page: float = 0.03125,
                 dcn_ticks_per_page: float = 0.0625,
                 backoff_ticks: int = 1,
                 recover_after: int = 2,
                 placement: Optional[Mapping[str, int]] = None,
                 transfer: Optional[PageTransfer] = None,
                 reshard: Optional[PageReshard] = None,
                 use_reshard: bool = True,
                 **kwargs):
        prefills = _as_pool(prefill_engines)
        decodes = _as_pool(decode_engines)
        _validate_replicas(prefills, decodes)
        if kwargs.get("chunk_tokens") is not None:
            raise ValueError(
                "chunked prefill stays colocated: the pool router "
                "runs monolithic admission prefill on the remote "
                "replicas (the chunks would serialize against the "
                "very decode ticks disaggregation unblocks)")
        pnames, dnames = _pool_names(len(prefills), len(decodes))
        known = set(pnames) | set(dnames)
        unknown = set(placement or {}) - known
        if unknown:
            raise ValueError(
                f"placement names unknown replicas {sorted(unknown)}; "
                f"pool replicas are {sorted(known)}")
        eng0 = decodes[0]
        if transfer is None:
            transfer = PageTransfer(injector=eng0.injector,
                                    tracer=eng0.tracer,
                                    stats=eng0.stats,
                                    max_retries=transfer_max_retries)
        if reshard is None and use_reshard:
            reshard = PageReshard(injector=eng0.injector,
                                  tracer=eng0.tracer,
                                  stats=eng0.stats,
                                  max_retries=transfer_max_retries)
        if not use_reshard:
            reshard = None
        owners = _owners(list(zip(pnames + dnames,
                                  list(prefills) + list(decodes))))
        wire = None if owners is None \
            else _pool_wire(owners, [reshard, transfer])
        engine = _PoolEngine(prefills, decodes, transfer, reshard,
                             handoff_ticks_per_page,
                             ici_ticks_per_page, dcn_ticks_per_page,
                             backoff_ticks, recover_after, placement,
                             owners, wire)
        super().__init__(engine, eos_id, **kwargs)

    @property
    def health(self) -> Dict[str, ReplicaHealth]:
        return self.engine.health

    def _admit(self) -> None:
        eng = self.engine
        eng.begin_admission_pass()
        eng.health_tick()
        if eng.active_down:
            target = eng.pick_active_target()
            if target is not None:
                self._move_active(target, cause="failover")
                self.stats.failovers += 1
            # else: last replica standing keeps serving on the incumbent
        elif eng.active_borrowed:
            target = eng.pick_home_decode()
            if target is not None:
                # a decode replica recovered: the slots move home and
                # the borrowed prefill replica rejoins its pool
                self._move_active(target, cause="rebalance")
        super()._admit()

    def _move_active(self, target: str, cause: str) -> None:
        """Drain the occupied slots (the bit-exact preemption resume) and
        move the decode placement to ``target``; admission goes on this
        tick on the new active replica."""
        eng = self.engine
        trc = self.tracer
        if trc.enabled and cause == "failover":
            trc.instant("failover",
                        slots=sum(s is not None for s in self._slots),
                        replica=eng.active_name, target=target)
        _preempt_drain(self, cause)
        eng.set_active(target)

"""Continuous batching over a fixed-slot KV cache (counterpart of
``apex_tpu/serving/scheduler.py``; dense or paged cache, greedy and
sampled requests with the engine's top-k / top-p, plain decode,
bf16/fp32 or weight-only int8 params, a bf16/fp32 or int8 page pool).

A FIFO of requests is multiplexed onto ``num_slots`` cache rows. A slot
is admitted with one bucketed prefill, then every tick advances ALL
occupied slots with one batched decode step; a slot is evicted the
moment it emits EOS, hits its ``max_new_tokens``, or fills its cache
row, and the freed row is re-admitted from the queue on the next tick.

A sampled request's token ``n`` draws with the key ``fold_in(PRNGKey(
seed), n)`` (``utils.prng``): the prefill's first token with ``n = 0``,
each decode step with ``n = len(generated)``; slots that are not
decoding get ``PRNGKey(0)``, as in the JAX scheduler. So a replayed
stream, and the JAX scheduler's, commit the same tokens.

Every committed token passes two gates first: its logits row is finite
and the sampled id is inside the vocabulary. A row that fails raises
:class:`~apex_tpu_torch.serving.health.NonFiniteLogits` before anything
of that tick is committed.

On the paged engine (:class:`PagedDecodeEngine`) admission shares the
longest cached prompt prefix (whole pages, and an exact partial last
page) and copy-on-write keeps shared pages unmodified. When the pool
cannot cover an admission (:class:`~apex_tpu_torch.serving.health.
PoolExhausted`) the queue waits in FIFO order; when a decode tick cannot
get a page, the engine preempts the slot, and the scheduler requeues its
request at the queue front (newest first) with the tokens it has
committed. Re-admission prefills the prompt plus all of them but the
last, which the next decode tick feeds, so a resumed request continues
its stream. Faults, tracing, tenancy, streams, speculative decoding,
chunked prefill and the host spill tier are later slices.

The engine's cache is updated in place by each step.
"""

import dataclasses
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from apex_tpu_torch.models.gpt import GPTConfig
from apex_tpu_torch.quant.params import is_quantized_tree
from apex_tpu_torch.serving.cache import (
    NULL_PAGE, RESERVED_PAGES, SCRATCH_PAGE, audit_block_tables, init_cache,
    init_paged_cache, max_pages_per_slot,
)
from apex_tpu_torch.serving.decode import (
    make_copy_page_fn, make_decode_fn, make_paged_decode_fn,
    make_paged_prefill_fn, make_prefill_fn,
)
from apex_tpu_torch.serving.health import (
    NonFiniteLogits, PoolExhausted, RequestOutcome,
)
from apex_tpu_torch.serving.paging import PagePool, prefix_page_keys
from apex_tpu_torch.serving.sampling import finite_rows, sample_tokens
from apex_tpu_torch.utils import prng
from apex_tpu_torch.utils.platform import DeviceLike, resolve_device
from apex_tpu_torch.utils.seqlen import (
    bucket_for, default_buckets, pad_to_bucket,
)


@dataclasses.dataclass(frozen=True)
class Request:
    """One generation request. ``temperature <= 0`` means greedy;
    ``seed`` roots a sampled request's random stream."""
    prompt: Tuple[int, ...]
    max_new_tokens: int = 16
    temperature: float = 0.0
    seed: int = 0


@dataclasses.dataclass
class _Slot:
    request_id: int
    request: Request
    prompt_len: int
    generated: List[int]
    pos: int            # cache rows written (prompt + decode steps)


class DecodeEngine:
    """Owns the params, the cache and the prefill/decode steps. Params
    must already lie on ``device`` (``None`` means the card). A
    weight-only int8 tree (``quant.quantize_params``) is detected and
    served through the w8 kernels; ``compute_dtype`` is then the
    activations' dtype (fp32 with None), as in the JAX engine.
    ``top_k`` / ``top_p`` restrict every sampled row (0 = off)."""

    paged = False

    def __init__(self, params, cfg: GPTConfig, num_slots: int,
                 max_len: int, cache_dtype: torch.dtype = torch.bfloat16,
                 top_k: int = 0, top_p: float = 0.0,
                 buckets: Optional[Sequence[int]] = None,
                 compute_dtype: Optional[torch.dtype] = None,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.params = params
        self.cfg = cfg
        self.num_slots = num_slots
        self.max_len = max_len
        self.top_k = top_k
        self.top_p = top_p
        if buckets is None:
            buckets = default_buckets(max_len, min(128, max_len))
        # clamp the ladder to the cache: prefill rejects buckets beyond
        # S_max, and the top-of-ladder bucket may overshoot max_len
        self.buckets = tuple(sorted({min(int(b), max_len)
                                     for b in buckets}))
        if cache_dtype == torch.int8:
            raise ValueError(
                "the dense cache has no int8 mode (per-page scales need "
                "pages); use PagedDecodeEngine for kv_dtype=int8")
        quantized = is_quantized_tree(params)
        self.cache = init_cache(cfg, num_slots, max_len, cache_dtype,
                                self.device)
        self._prefill = make_prefill_fn(cfg, compute_dtype, quantized)
        self._decode = make_decode_fn(cfg, compute_dtype, quantized)

    def prefill(self, slot: int, prompt: Sequence[int]) -> torch.Tensor:
        """Full forward over ``prompt`` into cache row ``slot``; returns
        the last-real-token logits (1, V)."""
        ids = torch.tensor([list(prompt)], dtype=torch.int64,
                           device=self.device)
        ids, mask = pad_to_bucket(ids, ids.shape[1], buckets=self.buckets)
        self.cache, logits = self._prefill(self.params, self.cache, ids,
                                           mask, slot)
        return logits

    def decode(self, tokens: Sequence[int],
               active: Sequence[bool]) -> torch.Tensor:
        """One token for every slot; ``active`` gates the length
        advance. Returns (num_slots, V) fp32 logits."""
        tok = torch.tensor(list(tokens), dtype=torch.int64,
                           device=self.device)
        act = torch.tensor(list(active), dtype=torch.bool,
                           device=self.device)
        self.cache, logits = self._decode(self.params, self.cache, tok, act)
        return logits

    def sample(self, logits: torch.Tensor, keys,
               temperature: Sequence[float]) -> torch.Tensor:
        """(B,) int32 tokens; ``keys`` (B, 2) and ``temperature`` (B,)
        on the host. A batch of greedy rows only takes the argmax and
        draws nothing."""
        if max(temperature) <= 0:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        return sample_tokens(logits, keys, torch.tensor(
            list(temperature), dtype=torch.float32, device=logits.device),
            self.top_k, self.top_p)

    def finite(self, logits: torch.Tensor) -> torch.Tensor:
        """(B,) bool: which logits rows are safe to sample."""
        return finite_rows(logits)

    # scheduler hooks, no-ops for the dense engine: a cache row needs no
    # per-token capacity and frees by being overwritten
    def page_demand(self, total_len: int) -> None:
        """Validate a request's worst-case capacity need at submit."""

    def prepare_decode(self, positions: Dict[int, int]) -> List[int]:
        """Slots that had to be preempted to decode (none here)."""
        return []

    def free_slot(self, slot: int) -> None:
        """Release slot-owned resources on eviction (none here)."""

    def check_invariants(self) -> bool:
        """Audit engine-owned bookkeeping (pool refcounts, block
        tables); trivially true for the dense cache."""
        return True

    def pool_snapshot(self) -> Dict:
        """Allocator state for diagnostics."""
        return {}

    def pool_gauges(self) -> Optional[Dict[str, float]]:
        """Gauge sources (``None``: the dense cache has no page pool to
        meter)."""
        return None

    def pop_admit_charge(self, default: int) -> int:
        """Tick-clock cost of the admission prefill the scheduler just
        ran: the forward's sequential depth, ``default`` (an engine that
        replaced part of that depth with cheaper work would stage
        another charge here)."""
        return default


def _owed(item: str, **given) -> None:
    """Raise for a parameter owed to a later ROADMAP item when it is
    given a value other than its default."""
    names = [n for n, set_ in given.items() if set_]
    if names:
        raise NotImplementedError(
            f"PagedDecodeEngine({', '.join(names)}=...): ROADMAP item "
            f"{item}, not ported yet")


class PagedDecodeEngine(DecodeEngine):
    """:class:`DecodeEngine` over the paged cache: a fixed page pool,
    per-slot block tables, and a host-side
    :class:`~apex_tpu_torch.serving.paging.PagePool` deciding placement.
    Admission shares the longest cached prompt prefix (whole pages, and
    a partial last page on an exact match) instead of recomputing it;
    :meth:`prepare_decode` runs before every decode tick to allocate
    page-boundary pages and clone (copy-on-write) any shared page a slot
    is about to append into, so the decode step only writes pages the
    slot owns alone (or scratch). ``free_order`` permutes the initial
    free list: the logits do not depend on physical placement.
    ``cow_copies``, ``preemptions`` and ``pool_exhausted`` count the
    copy-on-write clones, the preemptions and the admissions the pool
    refused (the JAX engine's ``ServingStats`` names).

    Every parameter of the JAX engine is taken; those owed to later
    ROADMAP items raise on a value other than their default: ``spec_k``,
    ``draft_model``, ``tree_spec``, ``adaptive_spec`` (A4.2,
    speculative decoding), ``injector``, ``tracer`` (A4.4, faults and
    tracer), ``host_tier``, ``promote_ticks_per_page`` (A4.1b, the host
    spill tier)."""

    paged = True

    def __init__(self, params, cfg: GPTConfig, num_slots: int,
                 max_len: int, num_pages: int, page_size: int,
                 cache_dtype: torch.dtype = torch.bfloat16, top_k: int = 0,
                 top_p: float = 0.0, spec_k: int = 0,
                 buckets: Optional[Sequence[int]] = None,
                 compute_dtype: Optional[torch.dtype] = None,
                 free_order: Optional[Sequence[int]] = None,
                 prefix_sharing: bool = True, injector=None,
                 draft_model=None, tree_spec: bool = False,
                 adaptive_spec: bool = False, tracer=None,
                 host_tier=None, promote_ticks_per_page: float = 0.125,
                 device: DeviceLike = None):
        _owed("A4.2 (speculative decoding)", spec_k=spec_k != 0,
              draft_model=draft_model is not None, tree_spec=tree_spec,
              adaptive_spec=adaptive_spec)
        _owed("A4.4 (faults, tracer and tenancy)",
              injector=injector is not None, tracer=tracer is not None)
        _owed("A4.1b (the host spill tier)",
              host_tier=host_tier is not None,
              promote_ticks_per_page=promote_ticks_per_page != 0.125)
        self.device = resolve_device(device)
        self.params = params
        self.cfg = cfg
        self.num_slots = num_slots
        self.max_len = max_len
        self.page_size = page_size
        self.max_pages = max_pages_per_slot(max_len, page_size)
        self.prefix_sharing = prefix_sharing
        if buckets is None:
            buckets = default_buckets(max_len, min(128, max_len))
        self.buckets = tuple(sorted({min(int(b), max_len)
                                     for b in buckets}))
        bad = [b for b in self.buckets if b % page_size]
        if bad:
            raise ValueError(
                f"paged prefill writes whole pages: buckets {bad} are "
                f"not multiples of page_size {page_size}")
        self.top_k = top_k
        self.top_p = top_p
        self.spec_k = spec_k
        self.cow_copies = self.preemptions = self.pool_exhausted = 0
        quantized = is_quantized_tree(params)
        self.cache = init_paged_cache(cfg, num_slots, max_len, num_pages,
                                      page_size, cache_dtype, self.device)
        self.pool = PagePool(num_pages, page_size, free_order)
        self._slot_pages: List[List[int]] = [[] for _ in range(num_slots)]
        self._prefill = make_paged_prefill_fn(cfg, compute_dtype,
                                              quantized)
        self._decode = make_paged_decode_fn(cfg, compute_dtype, quantized)
        self._copy = make_copy_page_fn()

    def page_demand(self, total_len: int) -> None:
        need = max_pages_per_slot(min(total_len, self.max_len),
                                  self.page_size)
        usable = self.pool.num_pages - RESERVED_PAGES
        if need > usable:
            raise ValueError(
                f"request needs up to {need} pages but the pool only "
                f"has {usable} usable pages")

    def _tensor(self, row) -> torch.Tensor:
        return torch.from_numpy(np.asarray(row, np.int32)).to(self.device)

    def prefill(self, slot: int, prompt: Sequence[int]) -> torch.Tensor:
        """Admit ``prompt`` into ``slot``: share the longest cached
        prefix run, allocate private pages for the rest, prefill —
        writing ONLY the private pages (shared ones are redirected to
        scratch; their rows are the original request's, reused as they
        are) — and register the chain for later requests. Raises
        :class:`PoolExhausted` when the pool cannot cover the prompt
        even after LRU eviction, having released every page reference
        it took; ``ValueError`` for a prompt beyond ``max_len`` before
        touching the pool."""
        toks = [int(t) for t in prompt]
        if len(toks) > self.max_len:
            raise ValueError(
                f"prompt length {len(toks)} exceeds cache max_len "
                f"{self.max_len}")
        n_pages = max_pages_per_slot(len(toks), self.page_size)
        keys = prefix_page_keys(toks, self.page_size)
        shared = self.pool.match_prefix(keys) if self.prefix_sharing \
            else []
        private: List[int] = []
        for _ in range(n_pages - len(shared)):
            p = self.pool.alloc()
            if p is None:
                for q in shared + private:
                    self.pool.release(q)
                raise PoolExhausted(
                    f"prompt needs {n_pages} pages; pool has "
                    f"{self.pool.num_free} free and nothing left to "
                    "evict", need=n_pages, free=self.pool.num_free,
                    cached=self.pool.num_cached)
            private.append(p)
        pages = shared + private
        self._slot_pages[slot] = list(pages)
        row = np.full((self.max_pages,), NULL_PAGE, np.int32)
        row[:n_pages] = pages
        ids = torch.tensor([toks], dtype=torch.int64, device=self.device)
        ids, mask = pad_to_bucket(ids, ids.shape[1], buckets=self.buckets)
        write = np.full((ids.shape[1] // self.page_size,), SCRATCH_PAGE,
                        np.int32)
        write[len(shared):n_pages] = private
        self.cache, logits = self._prefill(
            self.params, self.cache, ids, mask, slot, self._tensor(write),
            self._tensor(row))
        if self.prefix_sharing:
            self.pool.register_prefix(keys, pages)
        return logits

    def prepare_decode(self, positions: Dict[int, int]) -> List[int]:
        """Before a tick writes row ``pos`` of each slot: cross a page
        boundary by allocating a fresh page, and clone (copy-on-write) a
        shared page about to receive the row — unless the failed clone
        allocation's registry eviction left the slot sole owner, when
        the append proceeds in place. A slot the pool cannot serve is
        preempted: its pages are released (often unblocking the rest of
        the batch) and the caller requeues its request. Returns the
        preempted slots."""
        preempted: List[int] = []
        for i, pos in sorted(positions.items()):
            pages = self._slot_pages[i]
            idx = pos // self.page_size
            if idx == len(pages):                       # page boundary
                p = self.pool.alloc()
                if p is None:
                    self._preempt(i, preempted)
                    continue
                pages.append(p)
                self.cache.block_tables[i, idx] = p
            elif self.pool.needs_copy(pages[idx]):      # COW
                dst = self.pool.alloc()
                if dst is None:
                    # the failed alloc's LRU sweep emptied the prefix
                    # registry; if the registry was the page's only
                    # co-owner the append is now legal in place, and
                    # preempting would recreate the same state on
                    # re-admission (a livelock)
                    if not self.pool.needs_copy(pages[idx]):
                        continue
                    self._preempt(i, preempted)
                    continue
                self.cow_copies += 1
                self.cache = self._copy(self.cache, pages[idx], dst)
                self.cache.block_tables[i, idx] = dst
                self.pool.release(pages[idx])
                pages[idx] = dst
        return preempted

    def _preempt(self, slot: int, preempted: List[int]) -> None:
        self.free_slot(slot)
        self.preemptions += 1
        preempted.append(slot)

    def free_slot(self, slot: int) -> None:
        """Release the slot's page references and park its block-table
        row on scratch (a freed slot's decode writes must never land in
        a page the allocator may hand to someone else)."""
        for p in self._slot_pages[slot]:
            self.pool.release(p)
        self._slot_pages[slot] = []
        self.cache.block_tables[slot] = SCRATCH_PAGE

    def check_invariants(self) -> bool:
        """Full pool audit: the host refcounts, free list and registry
        against the per-slot page lists
        (:meth:`~apex_tpu_torch.serving.paging.PagePool.check_invariants`),
        then the device block tables against the same lists
        (:func:`~apex_tpu_torch.serving.cache.audit_block_tables`).
        Raises :class:`~apex_tpu_torch.serving.health.PoolInvariantError`."""
        self.pool.check_invariants(self._slot_pages)
        audit_block_tables(self.cache.block_tables, self._slot_pages)
        return True

    def pool_snapshot(self) -> Dict:
        snap = self.pool.snapshot()
        snap["slot_pages"] = [list(p) for p in self._slot_pages]
        return snap

    def pool_gauges(self) -> Dict[str, float]:
        return {"free": self.pool.num_free,
                "cached": self.pool.num_cached,
                "occupancy": self.pool.occupancy}


def _slot_key(slot: _Slot) -> torch.Tensor:
    """The key of the slot's next token: ``fold_in(PRNGKey(seed),
    len(generated))``."""
    return prng.fold_in(prng.PRNGKey(slot.request.seed),
                        len(slot.generated))


class ContinuousBatchingScheduler:
    """FIFO -> fixed slots -> batched decode ticks, with typed outcomes
    in ``self.outcomes`` and the batched decode steps run so far in
    ``self.decode_steps``."""

    def __init__(self, engine: DecodeEngine, eos_id: int):
        self.engine = engine
        self.eos_id = eos_id
        self.outcomes: Dict[int, RequestOutcome] = {}
        self._queue: deque = deque()
        self._slots: List[Optional[_Slot]] = [None] * engine.num_slots
        self._next_id = 0
        self._submit_tick: Dict[int, int] = {}
        self._first_token_tick: Dict[int, int] = {}
        self._prefill_ticks: Dict[int, int] = {}
        self._tick_no = 0
        self.decode_steps = 0

    def submit(self, request: Request) -> int:
        if not len(request.prompt):
            raise ValueError("empty prompt")
        if len(request.prompt) > self.engine.max_len:
            raise ValueError(
                f"prompt length {len(request.prompt)} exceeds cache "
                f"max_len {self.engine.max_len}")
        bucket_for(len(request.prompt), self.engine.buckets)
        self.engine.page_demand(
            len(request.prompt) + request.max_new_tokens)
        rid = self._next_id
        self._next_id += 1
        self._submit_tick[rid] = self._tick_no
        # (id, request, tokens committed before a preemption)
        self._queue.append((rid, request, []))
        return rid

    def _finish(self, rid: int, tokens: Sequence[int], reason: str) -> None:
        ttft = None
        if rid in self._first_token_tick:
            ttft = self._first_token_tick[rid] - self._submit_tick[rid]
        self.outcomes[rid] = RequestOutcome(
            tuple(int(t) for t in tokens), reason, ttft_ticks=ttft,
            total_ticks=self._tick_no - self._submit_tick[rid],
            prefill_ticks=self._prefill_ticks.get(rid))

    def _charge_work(self, tokens: int) -> None:
        """Tick clock: a forward that advances one stream by ``tokens``
        positions costs that many ticks (a decode step is one); the
        engine may reprice it (``pop_admit_charge``)."""
        tokens = self.engine.pop_admit_charge(tokens)
        if tokens > 1:
            self._tick_no += tokens - 1

    def _commit(self, i: int, tok: int) -> None:
        slot = self._slots[i]
        slot.generated.append(tok)
        self._first_token_tick.setdefault(slot.request_id, self._tick_no)
        self._maybe_evict(i)

    def _check(self, finite: bool, tok: int, what: str) -> None:
        vocab = self.engine.cfg.vocab_size
        if not finite:
            raise NonFiniteLogits(f"{what}: non-finite logits")
        if not 0 <= tok < vocab:
            raise NonFiniteLogits(
                f"{what}: sampled token {tok} outside [0, {vocab})")

    def _admit(self) -> None:
        eng = self.engine
        for i in range(eng.num_slots):
            if self._slots[i] is not None or not self._queue:
                continue
            rid, req, resume = self._queue[0]
            # a preempted request resumes by re-prefilling everything it
            # had produced EXCEPT its last token, which the next decode
            # tick feeds
            tokens = tuple(req.prompt) + tuple(resume[:-1])
            try:
                logits = eng.prefill(i, tokens)
            except PoolExhausted as e:
                # out of pages: keep FIFO order and wait for evictions,
                # unless the pool cannot serve the head even with every
                # slot free (submit-time validation should have refused
                # it)
                eng.pool_exhausted += 1
                if all(s is None for s in self._slots):
                    raise PoolExhausted(
                        "page pool cannot admit the queue head even with "
                        f"every slot free (request {rid}) — submit-time "
                        "validation should have rejected it", need=e.need,
                        free=e.free, cached=e.cached) from e
                break
            self._prefill_ticks[rid] = self._prefill_ticks.get(rid, 0) + 1
            self._charge_work(len(tokens))
            first_tok = None
            if not resume:
                # the first generated token comes from the prefill
                # logits; a resumed request has it already
                finite = bool(eng.finite(logits).all())
                key = prng.fold_in(prng.PRNGKey(req.seed), 0)
                first_tok = int(eng.sample(logits, key[None],
                                           [req.temperature])[0])
                self._check(finite, first_tok, f"request {rid}: prefill")
            self._queue.popleft()
            self._slots[i] = _Slot(rid, req, len(req.prompt), list(resume),
                                   len(tokens))
            if first_tok is None:
                self._maybe_evict(i)
            else:
                self._commit(i, first_tok)

    def _maybe_evict(self, i: int) -> None:
        slot = self._slots[i]
        if slot.generated[-1] == self.eos_id:
            reason = "eos"
        elif len(slot.generated) >= slot.request.max_new_tokens:
            reason = "length"
        elif slot.prompt_len + len(slot.generated) > self.engine.max_len:
            reason = "cache_full"
        else:
            return
        self._finish(slot.request_id, slot.generated, reason)
        self._slots[i] = None
        self.engine.free_slot(i)

    def _decode_phase(self) -> int:
        """One decode step over every occupied slot (the plain branch of
        the JAX scheduler's decode phase); returns the slots advanced."""
        eng = self.engine
        positions = {i: s.pos for i, s in enumerate(self._slots)
                     if s is not None}
        # requeue preempted slots at the front in submission order:
        # appendleft of the newest first leaves the oldest at the front
        preempted = eng.prepare_decode(positions)
        for i in sorted(preempted, key=lambda j: self._slots[j].request_id,
                        reverse=True):
            s = self._slots[i]
            self._queue.appendleft((s.request_id, s.request,
                                    list(s.generated)))
            self._slots[i] = None
        occupied = [i for i, s in enumerate(self._slots) if s is not None]
        if not occupied:
            return 0
        tokens = [s.generated[-1] if s is not None else 0
                  for s in self._slots]
        active = [s is not None for s in self._slots]
        temps = [s.request.temperature if s is not None else 0.0
                 for s in self._slots]
        keys = torch.stack([_slot_key(s) if s is not None
                            else prng.PRNGKey(0) for s in self._slots])
        logits = eng.decode(tokens, active)
        self.decode_steps += 1
        finite = eng.finite(logits).tolist()
        next_tokens = eng.sample(logits, keys, temps).tolist()
        for i in occupied:
            self._check(finite[i], next_tokens[i],
                        f"slot {i} (request {self._slots[i].request_id})"
                        ": decode")
        for i in occupied:
            self._slots[i].pos += 1
            self._commit(i, next_tokens[i])
        return len(occupied)

    @property
    def busy(self) -> bool:
        """Work pending: queued requests or occupied slots."""
        return bool(self._queue) or any(s is not None for s in self._slots)

    def step(self) -> None:
        """One scheduler tick: admit into free slots, then decode."""
        self._tick_no += 1
        self._admit()
        self._decode_phase()

    def run(self) -> List[List[int]]:
        """Drain the queue; returns generated tokens (EOS included when
        emitted) per request, in submission order."""
        while self.busy:
            self.step()
        return [list(self.outcomes[rid].tokens)
                for rid in sorted(self.outcomes)]

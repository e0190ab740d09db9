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
its stream.

Speculative decoding (``spec_k > 0``): each tick drafts up to
``spec_k`` candidates a slot (the host n-gram drafter, ``serving.draft``,
or a :class:`~apex_tpu_torch.serving.draft_model.DraftModel`), runs ONE
verify step over the k1 = spec_k + 1 candidate positions, samples every
position with the key the plain stream would use there
(``fold_in(PRNGKey(seed), n_generated + j)``), and commits the longest
prefix where the samples reproduce the drafts plus the first
non-matching sample: 1..k1 tokens a slot a tick, the committed stream
the plain one token for token. A tick that commits m tokens advances
the clock by m. The tick is a plain decode step when every draft is
empty or a slot lacks k1 rows of headroom. ``tree_spec`` verifies draft
trees (a chain plus an alternate root child) in one tree-attention
step and walks the accepted path; committed tokens stranded off the
leftmost chain are re-sent as the next tick's forced chain.
``adaptive_spec`` scales each slot's draft depth by an EWMA of its
acceptance (with a probe every 16 ticks once it reaches 0) and narrows
the grid to the widest draft proposed.

The host spill tier (``PagedDecodeEngine(host_tier=...)``): a page the
pool's eviction sweep drops from the prefix registry is copied to host
memory under its chain key; an admission that misses the device but
hits the tier promotes the records back (checksum and header verified)
and prefills only the suffix, its admission charged the suffix's depth
plus ``promote_ticks_per_page`` a promoted page.

Faults, tracing, tenancy, streams and chunked prefill are later slices.

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
    make_copy_page_fn, make_decode_fn, make_paged_chunk_prefill_fn,
    make_paged_decode_fn, make_paged_prefill_fn, make_paged_tree_verify_fn,
    make_paged_verify_fn, make_prefill_fn, make_tree_verify_fn,
    make_verify_fn,
)
from apex_tpu_torch.serving.draft import ngram_draft, tree_arrays
from apex_tpu_torch.serving.health import (
    NonFiniteLogits, PoolExhausted, PromoteFailed, RequestOutcome,
)
from apex_tpu_torch.serving.paging import (
    PAGE_KEY_VERSION, SPILL_DTYPE_TAGS, PagePool, PrefixRegistry,
    SpillRecord, decode_spill_header, encode_spill_header, prefix_page_keys,
    spill_checksum,
)
from apex_tpu_torch.serving.sampling import (
    finite_rows, sample_token_grid, sample_tokens, tree_speculative_accept,
)
from apex_tpu_torch.serving.transfer import (
    make_extract_pages_fn, make_extract_pages_quant_fn, make_insert_pages_fn,
    make_insert_pages_quant_fn,
)
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
    """Owns the params, the cache and the prefill/decode/verify steps.
    Params must already lie on ``device`` (``None`` means the card). A
    weight-only int8 tree (``quant.quantize_params``) is detected and
    served through the w8 kernels; ``compute_dtype`` is then the
    activations' dtype (fp32 with None), as in the JAX engine.
    ``top_k`` / ``top_p`` restrict every sampled row (0 = off).
    ``spec_k`` is the draft depth (0: no speculation); ``draft_model``
    (a :class:`~apex_tpu_torch.serving.draft_model.DraftModel`),
    ``tree_spec`` and ``adaptive_spec`` need ``spec_k >= 1``."""

    paged = False

    def __init__(self, params, cfg: GPTConfig, num_slots: int,
                 max_len: int, cache_dtype: torch.dtype = torch.bfloat16,
                 top_k: int = 0, top_p: float = 0.0, spec_k: int = 0,
                 buckets: Optional[Sequence[int]] = None,
                 compute_dtype: Optional[torch.dtype] = None,
                 draft_model=None, tree_spec: bool = False,
                 adaptive_spec: bool = False, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.params = params
        self.cfg = cfg
        self.num_slots = num_slots
        self.max_len = max_len
        self.top_k = top_k
        self.top_p = top_p
        self.spec_k = spec_k
        self._check_spec_config(draft_model, tree_spec, adaptive_spec)
        self.draft_model = draft_model
        self.tree_spec = tree_spec
        self.adaptive_spec = adaptive_spec
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
        self._verify = make_verify_fn(cfg, compute_dtype, quantized)
        self._tree_verify = make_tree_verify_fn(
            cfg, compute_dtype, quantized) if tree_spec else None

    def _check_spec_config(self, draft_model, tree_spec,
                           adaptive_spec) -> None:
        if (draft_model is not None or tree_spec or adaptive_spec) \
                and self.spec_k < 1:
            raise ValueError(
                "draft_model / tree_spec / adaptive_spec require "
                "spec_k >= 1 (speculation is otherwise disabled)")
        if draft_model is not None:
            if draft_model.num_slots != self.num_slots:
                raise ValueError(
                    f"draft model has {draft_model.num_slots} slots, "
                    f"engine has {self.num_slots}")
            if draft_model.cfg.vocab_size != self.cfg.vocab_size:
                raise ValueError(
                    "draft and target models must share a vocabulary "
                    f"({draft_model.cfg.vocab_size} vs "
                    f"{self.cfg.vocab_size})")

    def _ids(self, rows, dtype=torch.int64) -> torch.Tensor:
        return torch.as_tensor(np.asarray(rows), dtype=dtype,
                               device=self.device)

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
        """(B,) bool (or (B, k1) for a verify step's logits): which rows
        are safe to sample."""
        return finite_rows(logits)

    # -- speculative decoding -------------------------------------------

    def draft(self, history: Sequence[int]) -> List[int]:
        """Host-side n-gram draft of up to ``spec_k`` candidates from
        one slot's prompt + generated history."""
        return ngram_draft(history, self.spec_k)

    def draft_batch(self, histories, ks) -> List[List[int]]:
        """Model-draft every slot in one batched call: up to ``ks[i]``
        greedy continuation tokens of ``histories[i]`` from the attached
        :class:`~apex_tpu_torch.serving.draft_model.DraftModel` (a
        ``None`` history or ``k = 0`` yields an empty draft)."""
        return [[int(t) for t in c]
                for c in self.draft_model.draft(histories, ks)]

    def draft_tree_batch(self, histories, ks):
        """Tree drafts (``(tokens, parents)`` a slot, ``None`` when
        inactive) from the model drafter: a greedy chain plus an
        alternate root branch (:meth:`DraftModel.draft_tree`)."""
        return self.draft_model.draft_tree(histories, ks)

    def verify(self, tokens) -> torch.Tensor:
        """One speculative verify step: ``tokens`` (num_slots, k1) —
        column 0 the pending token, columns 1.. the (0-padded) drafts.
        Returns (num_slots, k1, V) fp32 logits; the lengths advance
        separately (:meth:`commit`) once the accept walk knows each
        slot's count."""
        self.cache, logits = self._verify(self.params, self.cache,
                                          self._ids(tokens))
        return logits

    def tree_verify(self, tokens, depth, anc) -> torch.Tensor:
        """One tree-attention verify step over a packed draft grid
        (:func:`~apex_tpu_torch.serving.draft.tree_arrays`): column j
        writes its row at ``lengths + j``, takes position ``lengths +
        depth[:, j]`` and sees the committed rows and its ancestors
        under ``anc``. Returns (num_slots, k1, V) fp32 logits."""
        self.cache, logits = self._tree_verify(
            self.params, self.cache, self._ids(tokens), self._ids(depth),
            self._ids(anc, torch.bool))
        return logits

    def commit(self, counts: Sequence[int]) -> None:
        """Advance slot lengths by each slot's committed row count — the
        host half of the verify step's rollback: rows past ``lengths +
        count`` were written but no mask admits them before a later
        step rewrites them."""
        self.cache.lengths.add_(self._ids(counts, torch.int32))

    def sample_grid(self, logits: torch.Tensor, keys,
                    temperature: Sequence[float]) -> torch.Tensor:
        """Sample every (slot, position) of a verify step's logits
        (B, k1, V) with its own key (keys (B, k1, 2)); (B, k1) int32. A
        greedy-only batch takes the argmax and draws nothing."""
        if max(temperature) <= 0:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        return sample_token_grid(logits, keys, torch.tensor(
            list(temperature), dtype=torch.float32, device=logits.device),
            self.top_k, self.top_p)

    # scheduler hooks, no-ops for the dense engine: a cache row needs no
    # per-token capacity and frees by being overwritten
    def page_demand(self, total_len: int) -> None:
        """Validate a request's worst-case capacity need at submit."""

    def prepare_decode(self, positions: Dict[int, int],
                       n_new: int = 1) -> List[int]:
        """Make every slot's next ``n_new`` write targets exclusive;
        returns the slots that had to be preempted (none here)."""
        return []

    def free_slot(self, slot: int) -> None:
        """Release slot-owned resources on eviction (the draft model's
        lockstep row, when one is attached)."""
        if self.draft_model is not None:
            self.draft_model.free_slot(slot)

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
        ran: the forward's sequential depth, ``default`` (the paged
        engine's host tier reprices it)."""
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
    :meth:`prepare_decode` runs before every decode or verify tick to
    allocate page-boundary pages and clone (copy-on-write) any shared
    page a slot is about to append into, so a step only writes pages
    the slot owns alone (or scratch). ``free_order`` permutes the
    initial free list: the logits do not depend on physical placement.
    ``cow_copies``, ``preemptions`` and ``pool_exhausted`` count the
    copy-on-write clones, the preemptions and the admissions the pool
    refused (the JAX engine's ``ServingStats`` names).

    ``host_tier`` (a :class:`~apex_tpu_torch.serving.paging.
    PrefixRegistry`) catches the prefix pages the pool evicts and
    promotes them back at admission, each promotion charged
    ``promote_ticks_per_page`` on the admission clock; ``host_spills``,
    ``host_spill_bytes``, ``host_promotes``, ``host_promote_bytes``,
    ``host_promote_ticks``, ``host_spill_failures`` and
    ``host_promote_failures`` count its traffic (the JAX names).
    Tree speculation is refused over the int8 pool, as in the JAX
    engine. ``injector`` and ``tracer`` (ROADMAP A4.4, faults and
    tracer) raise on a value other than their default."""

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
                 host_tier: Optional[PrefixRegistry] = None,
                 promote_ticks_per_page: float = 0.125,
                 device: DeviceLike = None):
        _owed("A4.4 (faults, tracer and tenancy)",
              injector=injector is not None, tracer=tracer is not None)
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
        self._check_spec_config(draft_model, tree_spec, adaptive_spec)
        if tree_spec and cache_dtype == torch.int8:
            raise ValueError(
                "tree verify is not offered over the int8 page pool: a "
                "branch commit would re-round committed history at "
                "branch-dependent scales; kv8 keeps linear speculation")
        self.draft_model = draft_model
        self.tree_spec = tree_spec
        self.adaptive_spec = adaptive_spec
        self.cow_copies = self.preemptions = self.pool_exhausted = 0
        self.host_spills = self.host_spill_bytes = 0
        self.host_promotes = self.host_promote_bytes = 0
        self.host_promote_ticks = 0
        self.host_spill_failures = self.host_promote_failures = 0
        quantized = is_quantized_tree(params)
        self.cache = init_paged_cache(cfg, num_slots, max_len, num_pages,
                                      page_size, cache_dtype, self.device)
        self.pool = PagePool(num_pages, page_size, free_order,
                             host_tier=host_tier)
        # the host spill tier: the pool's eviction sweep calls
        # _spill_page for pages the prefix registry alone holds; an
        # admission's registry miss promotes records back
        # (_promote_chain) and its clock charge is repriced at the
        # suffix's depth plus the promote ticks (pop_admit_charge)
        self.host_tier = host_tier
        self.promote_ticks_per_page = float(promote_ticks_per_page)
        self._admit_charge: Optional[int] = None
        if host_tier is not None:
            name = str(cache_dtype).replace("torch.", "")
            if name not in SPILL_DTYPE_TAGS:
                raise ValueError(
                    f"cache dtype {name!r} has no spill wire tag; the "
                    f"host tier speaks {sorted(SPILL_DTYPE_TAGS)}")
            self._spill_geometry = (cfg.num_layers, cfg.num_heads,
                                    page_size, cfg.head_dim,
                                    SPILL_DTYPE_TAGS[name])
            quant = cache_dtype == torch.int8
            self._tier_extract = (make_extract_pages_quant_fn()
                                  if quant else make_extract_pages_fn())
            self._tier_insert = (make_insert_pages_quant_fn()
                                 if quant else make_insert_pages_fn())
            self.pool.spill_hook = self._spill_page
        self._slot_pages: List[List[int]] = [[] for _ in range(num_slots)]
        self._prefill = make_paged_prefill_fn(cfg, compute_dtype,
                                              quantized)
        self._chunk_prefill = make_paged_chunk_prefill_fn(
            cfg, compute_dtype, quantized)
        self._decode = make_paged_decode_fn(cfg, compute_dtype, quantized)
        self._verify = make_paged_verify_fn(cfg, compute_dtype, quantized)
        self._tree_verify = make_paged_tree_verify_fn(
            cfg, compute_dtype, quantized) if tree_spec else None
        self._copy = make_copy_page_fn()

    def page_demand(self, total_len: int) -> None:
        need = max_pages_per_slot(min(total_len, self.max_len),
                                  self.page_size)
        usable = self.pool.num_pages - RESERVED_PAGES
        if need > usable:
            raise ValueError(
                f"request needs up to {need} pages but the pool only "
                f"has {usable} usable pages")

    def prefill(self, slot: int, prompt: Sequence[int]) -> torch.Tensor:
        """Admit ``prompt`` into ``slot``: share the longest cached
        prefix run, promote the next links of the chain from the host
        tier, allocate private pages for the rest, prefill — writing
        ONLY the private pages (shared and promoted ones are redirected
        to scratch; their rows are reused as they are) — and register
        the chain for later requests. With a host tier, fully covered
        leading pages are skipped: the suffix runs as one prompt chunk
        attending the covered pages through the real row (an int8 pool
        keeps the whole forward). Raises :class:`PoolExhausted` when the
        pool cannot cover the prompt even after LRU eviction, having
        released every page reference it took; ``ValueError`` for a
        prompt beyond ``max_len`` before touching the pool."""
        toks = [int(t) for t in prompt]
        if len(toks) > self.max_len:
            raise ValueError(
                f"prompt length {len(toks)} exceeds cache max_len "
                f"{self.max_len}")
        n_pages = max_pages_per_slot(len(toks), self.page_size)
        keys = prefix_page_keys(toks, self.page_size)
        shared = self.pool.match_prefix(keys) if self.prefix_sharing \
            else []
        promoted: List[int] = []
        promote_ticks = 0
        if self.host_tier is not None and self.prefix_sharing \
                and len(shared) < n_pages:
            promoted, promote_ticks = self._promote_chain(keys,
                                                          len(shared))
        covered = len(shared) + len(promoted)
        private: List[int] = []
        for _ in range(n_pages - covered):
            p = self.pool.alloc()
            if p is None:
                for q in shared + promoted + private:
                    self.pool.release(q)
                raise PoolExhausted(
                    f"prompt needs {n_pages} pages; pool has "
                    f"{self.pool.num_free} free and nothing left to "
                    "evict", need=n_pages, free=self.pool.num_free,
                    cached=self.pool.num_cached)
            private.append(p)
        pages = shared + promoted + private
        self._slot_pages[slot] = list(pages)
        row = np.full((self.max_pages,), NULL_PAGE, np.int32)
        row[:n_pages] = pages
        skip = 0
        if self.host_tier is not None and covered \
                and self.cache.k_scale is None:
            skip = min(covered, max(n_pages - 1, 0))
        start = skip * self.page_size
        ids = torch.tensor([toks[start:]], dtype=torch.int64,
                           device=self.device)
        ids, mask = pad_to_bucket(ids, ids.shape[1], buckets=self.buckets)
        write = np.full((ids.shape[1] // self.page_size,), SCRATCH_PAGE,
                        np.int32)
        if skip:
            for j in range(write.shape[0]):
                if covered <= skip + j < n_pages:
                    write[j] = pages[skip + j]
            self.cache, logits = self._chunk_prefill(
                self.params, self.cache, ids, mask, slot, start,
                self._ids(write, torch.int32), self._ids(row, torch.int32),
                self._ids(row, torch.int32))
        else:
            write[covered:n_pages] = private
            self.cache, logits = self._prefill(
                self.params, self.cache, ids, mask, slot,
                self._ids(write, torch.int32), self._ids(row, torch.int32))
        if self.prefix_sharing:
            self.pool.register_prefix(keys, pages)
        if self.host_tier is not None:
            # the forward ran the suffix's depth only, and each
            # promotion costs transfer ticks
            self._admit_charge = (len(toks) - start) + promote_ticks
        return logits

    def pop_admit_charge(self, default: int) -> int:
        """Pop the staged admission charge: a host-tier prefill stages
        the suffix's depth plus its promote ticks; otherwise
        ``default``."""
        charge, self._admit_charge = self._admit_charge, None
        return default if charge is None else charge

    @staticmethod
    def _host(t: torch.Tensor) -> np.ndarray:
        """A tile as a host array; bf16 crosses as its 16-bit integer
        bits (numpy has no bf16)."""
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return t.numpy()

    def _spill_page(self, key: bytes, page: int) -> None:
        """Pool eviction hook: copy ``page`` (held by the prefix registry
        alone, so its content is pristine — copy-on-write guarantees no
        slot appended to it) out to the host tier under its chain
        key."""
        tiles = [self._host(t) for t in self._tier_extract(self.cache,
                                                           [page])]
        k, v = tiles[:2]
        ks, vs = (tiles[2], tiles[3]) if len(tiles) == 4 else (None, None)
        header = encode_spill_header(key, *self._spill_geometry)
        rec = SpillRecord(header, k, v, ks, vs,
                          spill_checksum(header, k, v, ks, vs))
        if self.host_tier.put(key, rec):
            self.host_spills += 1
            self.host_spill_bytes += rec.nbytes

    def _verify_spill(self, key: bytes, rec: SpillRecord) -> None:
        """Checksum and header verification of a record about to be
        promoted. Raises :class:`PromoteFailed` on any mismatch."""
        digest = spill_checksum(rec.header, rec.k, rec.v, rec.k_scale,
                                rec.v_scale)
        if digest != rec.digest:
            raise PromoteFailed(
                f"spill record checksum mismatch for {key.hex()[:16]}",
                key=key.hex())
        hdr = decode_spill_header(rec.header)
        if hdr["key"] != key:
            raise PromoteFailed(
                f"spill header bound to {hdr['key'].hex()[:16]} but "
                f"registered under {key.hex()[:16]}", key=key.hex())
        geom = (hdr["num_layers"], hdr["num_heads"], hdr["page_size"],
                hdr["head_dim"], hdr["dtype_tag"])
        if hdr["version"] != PAGE_KEY_VERSION \
                or geom != self._spill_geometry:
            raise PromoteFailed(
                f"spill geometry {hdr} does not match this engine",
                key=key.hex())

    def _promote_chain(self, keys: List[bytes],
                       start: int) -> Tuple[List[int], int]:
        """Extend a device prefix match by promoting consecutive chain
        links from the host tier: verify each record, allocate a page,
        and copy the payloads back in one batched insert. The chain
        breaks at the first miss, failed verification (the stale record
        is dropped and counted) or pool exhaustion; pages promoted so
        far are kept and the rest of the prompt re-prefills. Returns
        ``(pages, ticks)``; the caller owns one reference a page and
        charges ``ticks`` on the admission clock."""
        pages: List[int] = []
        records: List[SpillRecord] = []
        failed = False
        for key in keys[start:]:
            rec = self.host_tier.get(key)
            if rec is None:
                break
            try:
                self._verify_spill(key, rec)
            except PromoteFailed:
                self.host_tier.drop(key)
                failed = True
                break
            p = self.pool.alloc()
            if p is None:
                break
            pages.append(p)
            records.append(rec)
        if failed:
            self.host_promote_failures += 1
        if not pages:
            return [], 0
        k = np.concatenate([r.k for r in records], axis=1)
        v = np.concatenate([r.v for r in records], axis=1)
        if records[0].k_scale is not None:
            ks = np.concatenate([r.k_scale for r in records], axis=1)
            vs = np.concatenate([r.v_scale for r in records], axis=1)
            self.cache = self._tier_insert(self.cache, pages, k, v, ks, vs)
        else:
            self.cache = self._tier_insert(self.cache, pages, k, v)
        ticks = max(1, int(np.ceil(
            len(pages) * self.promote_ticks_per_page)))
        self.host_promotes += len(pages)
        self.host_promote_bytes += sum(r.nbytes for r in records)
        self.host_promote_ticks += ticks
        return pages, ticks

    def prepare_decode(self, positions: Dict[int, int],
                       n_new: int = 1) -> List[int]:
        """Before a tick writes rows ``pos .. pos + n_new - 1`` of each
        slot (``n_new = k1`` on a verify tick): cross each page boundary
        by allocating a fresh page, and clone (copy-on-write) a shared
        page about to receive a row — unless the failed clone
        allocation's registry eviction left the slot sole owner, when
        the append proceeds in place. Pages past the committed length
        may exist from an earlier verify tick's overshoot; they are
        private and reused. A slot the pool cannot serve is preempted:
        its pages are released (often unblocking the rest of the batch)
        and the caller requeues its request. Returns the preempted
        slots."""
        preempted: List[int] = []
        for i, pos in sorted(positions.items()):
            pages = self._slot_pages[i]
            first = pos // self.page_size
            last = (pos + n_new - 1) // self.page_size
            for idx in range(first, last + 1):
                if idx == len(pages):                   # page boundary
                    p = self.pool.alloc()
                    if p is None:
                        self._preempt(i, preempted)
                        break
                    pages.append(p)
                    self.cache.block_tables[i, idx] = p
                elif self.pool.needs_copy(pages[idx]):  # COW
                    dst = self.pool.alloc()
                    if dst is None:
                        # the failed alloc's LRU sweep emptied the
                        # prefix registry; if the registry was the
                        # page's only co-owner the append is now legal
                        # in place, and preempting would recreate the
                        # same state on re-admission (a livelock)
                        if not self.pool.needs_copy(pages[idx]):
                            continue
                        self._preempt(i, preempted)
                        break
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
        row on scratch (a freed slot's writes must never land in a page
        the allocator may hand to someone else)."""
        for p in self._slot_pages[slot]:
            self.pool.release(p)
        self._slot_pages[slot] = []
        self.cache.block_tables[slot] = SCRATCH_PAGE
        if self.draft_model is not None:
            self.draft_model.free_slot(slot)

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
        gauges = {"free": self.pool.num_free,
                  "cached": self.pool.num_cached,
                  "occupancy": self.pool.occupancy}
        if self.host_tier is not None:
            stats = self.pool.stats()
            for name in ("hbm_used", "host_pages", "host_bytes",
                         "host_hit_rate"):
                gauges[name] = stats[name]
        return gauges


def _slot_key(slot: _Slot) -> torch.Tensor:
    """The key of the slot's next token: ``fold_in(PRNGKey(seed),
    len(generated))``."""
    return prng.fold_in(prng.PRNGKey(slot.request.seed),
                        len(slot.generated))


class ContinuousBatchingScheduler:
    """FIFO -> fixed slots -> batched decode (or verify) ticks, with
    typed outcomes in ``self.outcomes``. Counters (the JAX
    ``ServingStats`` names): ``decode_steps`` the batched decode and
    verify steps run, ``plain_ticks`` and ``spec_ticks`` the ticks of
    each kind, ``tokens_drafted`` and ``tokens_accepted`` the draft
    candidates proposed and accepted (:attr:`acceptance_rate`)."""

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
        self.plain_ticks = self.spec_ticks = 0
        self.tokens_drafted = self.tokens_accepted = 0
        # adaptive controller: a slot's EWMA of its measured acceptance
        # (reset to 1.0 at admission); a slot converged to depth 0 gets
        # a probe draft every _probe_every ticks
        self._accept_ewma = [1.0] * engine.num_slots
        self._probe_every = 16

    @property
    def acceptance_rate(self) -> float:
        """Accepted / drafted candidates (0.0 before any draft)."""
        if not self.tokens_drafted:
            return 0.0
        return self.tokens_accepted / self.tokens_drafted

    def submit(self, request: Request) -> int:
        if not len(request.prompt):
            raise ValueError("empty prompt")
        if len(request.prompt) > self.engine.max_len:
            raise ValueError(
                f"prompt length {len(request.prompt)} exceeds cache "
                f"max_len {self.engine.max_len}")
        # the prompt must have a bucket rung and (paged) fit the pool
        # alone at its worst-case length, plus a verify step's overshoot
        # (speculative rows land up to spec_k past the last committed
        # token)
        bucket_for(len(request.prompt), self.engine.buckets)
        self.engine.page_demand(
            len(request.prompt) + request.max_new_tokens
            + self.engine.spec_k)
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

    def _append(self, i: int, tok: int) -> None:
        slot = self._slots[i]
        slot.generated.append(tok)
        self._first_token_tick.setdefault(slot.request_id, self._tick_no)

    def _commit(self, i: int, tok: int) -> None:
        self._append(i, tok)
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
            self._accept_ewma[i] = 1.0
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
            # the committed stream no longer fits the cache row (in
            # plain mode the classic pos >= max_len)
            reason = "cache_full"
        else:
            return
        self._finish(slot.request_id, slot.generated, reason)
        self._slots[i] = None
        self.engine.free_slot(i)

    # -- speculation ------------------------------------------------------

    def _spec_ks(self, positions: Dict[int, int]) -> List[int]:
        """Each slot's draft depth this tick: ``spec_k``, or on an
        adaptive engine ``spec_k`` scaled by the slot's acceptance EWMA
        (0 turns its speculation off, with a depth-1 probe every
        ``_probe_every`` ticks)."""
        eng = self.engine
        ks = [0] * eng.num_slots
        for i in positions:
            if not eng.adaptive_spec:
                ks[i] = eng.spec_k
                continue
            k = int(round(self._accept_ewma[i] * eng.spec_k))
            if k <= 0 and self._tick_no % self._probe_every == 0:
                k = 1
            ks[i] = max(0, min(k, eng.spec_k))
        return ks

    def _histories(self, ks: List[int]) -> List[Optional[Tuple[int, ...]]]:
        return [tuple(s.request.prompt) + tuple(s.generated)
                if s is not None and ks[i] > 0 else None
                for i, s in enumerate(self._slots)]

    def _draft_all(self, ks: List[int]) -> List[List[int]]:
        """One linear draft a slot, up to ``ks[i]`` tokens deep (empty
        for free and depth-0 slots)."""
        eng = self.engine
        hists = self._histories(ks)
        if eng.draft_model is not None:
            return eng.draft_batch(hists, ks)
        return [[] if h is None else [int(t) for t in eng.draft(h)[:ks[i]]]
                for i, h in enumerate(hists)]

    def _draft_trees(self, ks: List[int]):
        """One draft tree a slot (``None`` for free and depth-0 slots):
        the model drafter's chain plus alternate root child, or the
        n-gram draft as a single chain."""
        eng = self.engine
        hists = self._histories(ks)
        if eng.draft_model is not None:
            return eng.draft_tree_batch(hists, ks)
        trees = []
        for i, h in enumerate(hists):
            d = [] if h is None else [int(t) for t in eng.draft(h)[:ks[i]]]
            trees.append((d, [-1] + list(range(len(d) - 1))) if d else None)
        return trees

    def _key_grid(self, offs) -> torch.Tensor:
        """(B, k1, 2) keys: ``fold_in(PRNGKey(seed), offs[b][j])`` for a
        decoding slot (the plain stream's key for that token),
        ``PRNGKey(0)``'s fold otherwise."""
        rows = []
        for i, s in enumerate(self._slots):
            base = prng.PRNGKey(s.request.seed if s is not None else 0)
            rows.append(torch.stack([prng.fold_in(base, int(o))
                                     for o in offs[i]]))
        return torch.stack(rows)

    def _temps(self) -> List[float]:
        return [s.request.temperature if s is not None else 0.0
                for s in self._slots]

    def _requeue(self, preempted: List[int]) -> None:
        """Requeue preempted slots at the queue front in submission
        order: appendleft of the newest first leaves the oldest at the
        front."""
        for i in sorted(preempted, key=lambda j: self._slots[j].request_id,
                        reverse=True):
            s = self._slots[i]
            self._queue.appendleft((s.request_id, s.request,
                                    list(s.generated)))
            self._slots[i] = None

    def _decode_phase(self) -> int:
        """One decode or verify step over every occupied slot (the JAX
        scheduler's decode phase); returns the positions computed."""
        eng = self.engine
        positions = {i: s.pos for i, s in enumerate(self._slots)
                     if s is not None}
        if eng.tree_spec and eng.spec_k > 0 and positions:
            spent = self._tree_tick(positions)
            if spent is not None:
                return spent
            # every forced chain was trivial and no draft survived
            drafts, spec, k1 = None, False, 1
        else:
            # speculate only when EVERY active slot has k1 rows of
            # headroom and some draft is non-empty; an adaptive engine
            # narrows the grid to 1 + the widest draft proposed
            drafts = self._draft_all(self._spec_ks(positions)) \
                if eng.spec_k > 0 and positions else None
            k1 = eng.spec_k + 1
            if drafts is not None and eng.adaptive_spec:
                k1 = 1 + max((len(drafts[i]) for i in positions),
                             default=0)
            spec = bool(drafts is not None and k1 > 1
                        and all(pos + k1 <= eng.max_len
                                for pos in positions.values())
                        and any(drafts[i] for i in positions))
        self._requeue(eng.prepare_decode(positions,
                                         n_new=k1 if spec else 1))
        occupied = [i for i, s in enumerate(self._slots) if s is not None]
        if not occupied:
            return 0
        if spec:
            self._spec_tick(drafts, k1)
            return k1 * len(occupied)
        self.plain_ticks += 1
        tokens = [s.generated[-1] if s is not None else 0
                  for s in self._slots]
        active = [s is not None for s in self._slots]
        keys = torch.stack([_slot_key(s) if s is not None
                            else prng.PRNGKey(0) for s in self._slots])
        logits = eng.decode(tokens, active)
        self.decode_steps += 1
        finite = eng.finite(logits).tolist()
        next_tokens = eng.sample(logits, keys, self._temps()).tolist()
        for i in occupied:
            self._check(finite[i], next_tokens[i],
                        f"slot {i} (request {self._slots[i].request_id})"
                        ": decode")
        for i in occupied:
            self._slots[i].pos += 1
            self._commit(i, next_tokens[i])
        return len(occupied)

    def _spec_tick(self, drafts: List[List[int]], k1: int) -> None:
        """Draft -> verify -> accept: one verify step over ``k1``
        candidate positions a slot, then a host walk that commits the
        longest prefix of grid samples reproducing the drafts plus the
        first non-matching sample (1..k1 tokens a slot). Position j
        samples with ``fold_in(seed, n_generated + j)``, the plain
        stream's key, so the committed stream is the plain one. Every
        committed position passes the finiteness and vocabulary gates
        before anything of the tick is committed."""
        eng = self.engine
        self.spec_ticks += 1
        rows = []
        for i, s in enumerate(self._slots):
            d = drafts[i][:k1 - 1]
            rows.append([s.generated[-1] if s is not None else 0]
                        + d + [0] * (k1 - 1 - len(d)))
        offs = [[(len(s.generated) if s is not None else 0) + j
                 for j in range(k1)] for s in self._slots]
        keys = self._key_grid(offs)
        logits = eng.verify(rows)
        self.decode_steps += 1
        finite = eng.finite(logits).tolist()                 # (B, k1)
        grid = eng.sample_grid(logits, keys, self._temps()).tolist()
        walks: Dict[int, List[int]] = {}
        for i, slot in enumerate(self._slots):
            if slot is None:
                continue
            draft = drafts[i]
            walk: List[int] = []
            accepted = 0
            for j in range(k1):
                tok = grid[i][j]
                self._check(finite[i][j], tok,
                            f"slot {i} (request {slot.request_id}): "
                            "verify")
                walk.append(tok)
                matched = j < len(draft) and draft[j] == tok
                accepted += matched
                if tok == self.eos_id or len(slot.generated) + len(walk) \
                        >= slot.request.max_new_tokens or not matched:
                    break
            walks[i] = walk
            self.tokens_drafted += len(draft)
            self.tokens_accepted += accepted
            if eng.adaptive_spec and draft:
                self._accept_ewma[i] = 0.5 * self._accept_ewma[i] \
                    + 0.5 * accepted / len(draft)
        counts = [0] * eng.num_slots
        for i, walk in walks.items():
            for tok in walk:
                self._append(i, tok)
            self._slots[i].pos += len(walk)
            counts[i] = len(walk)
        eng.commit(counts)
        # a tick that commits m tokens counts m on the clock
        if max(counts) > 1:
            self._tick_no += max(counts) - 1
        for i in walks:
            self._maybe_evict(i)

    def _tree_tick(self, positions: Dict[int, int]) -> Optional[int]:
        """Tree-speculative tick: pack every slot's FORCED chain (the
        committed tokens past its cache length, at least the pending
        token) and its draft tree into one verify grid, sample every
        node with the plain stream's key for its depth, and commit along
        the accepted root-to-leaf path
        (:func:`~apex_tpu_torch.serving.sampling.tree_speculative_accept`).
        Cache lengths advance by the row-contiguous committed prefix
        only; tokens a path strands off the leftmost chain are re-sent
        as the next tick's forced chain. Returns the positions computed,
        0 when every slot was preempted, or None (tick not taken) when
        every forced chain is trivial and no draft survived."""
        eng = self.engine
        trees = self._draft_trees(self._spec_ks(positions))
        forced: Dict[int, List[int]] = {}
        for i, s in enumerate(self._slots):
            if s is not None:
                h = list(s.request.prompt) + list(s.generated)
                forced[i] = h[s.pos:]        # f >= 1: the pending token
        if all(len(f) == 1 for f in forced.values()) \
                and not any(trees[i] is not None for i in positions):
            return None
        # grid width: the widest forced chain + tree, clamped to the
        # scarcest slot's headroom (a slot whose chain overflows catches
        # up across ticks, committing rows but sampling nothing)
        avail = min(eng.max_len - pos for pos in positions.values())
        k1 = max(len(forced[i])
                 + (len(trees[i][0]) if trees[i] is not None else 0)
                 for i in positions)
        k1 = max(1, min(k1, avail))
        preempted = eng.prepare_decode(positions, n_new=k1)
        for i in preempted:
            forced.pop(i, None)
        self._requeue(preempted)
        if not forced:
            return 0
        f_chain: List[List[int]] = []
        g_trees: List[Optional[Tuple[List[int], List[int]]]] = []
        for i, s in enumerate(self._slots):
            if s is None:
                f_chain.append([0])
                g_trees.append(None)
                continue
            chain = forced[i][:k1]
            room = k1 - len(chain)
            tree = trees[i]
            if tree is not None and len(chain) == len(forced[i]) \
                    and room > 0:
                # truncating a topological tree keeps parent validity
                toks = [int(t) for t in tree[0][:room]]
                pars = [int(p) for p in tree[1][:room]]
                g_trees.append((toks, pars) if toks else None)
            else:
                g_trees.append(None)
            f_chain.append(chain)
        tok_np, dep_np, anc_np, val_np, par_np, start_np = tree_arrays(
            f_chain, g_trees, k1)
        # column j samples the (n_generated - f + 1 + depth[j])-th
        # generated token: the plain stream's key offset there
        offs = np.zeros((eng.num_slots, k1), np.int64)
        for i, s in enumerate(self._slots):
            if s is not None:
                offs[i] = len(s.generated) - len(f_chain[i]) + 1 \
                    + dep_np[i]
        keys = self._key_grid(offs.tolist())
        logits = eng.tree_verify(tok_np, dep_np, anc_np)
        self.decode_steps += 1
        finite = eng.finite(logits)                       # (B, k1)
        grid = eng.sample_grid(logits, keys, self._temps())
        cnts, path = tree_speculative_accept(
            grid.cpu(), torch.from_numpy(tok_np), torch.from_numpy(par_np),
            torch.from_numpy(val_np), torch.from_numpy(start_np))
        cnts, path = cnts.tolist(), path.tolist()
        finite, grid = finite.tolist(), grid.tolist()
        plans: Dict[int, Tuple[int, List[int]]] = {}
        new_tok_max = 0
        for i, slot in enumerate(self._slots):
            if slot is None:
                continue
            f = len(f_chain[i])
            if f < len(forced[i]):
                # catch-up only: the truncated chain's rows commit,
                # nothing is sampled for this slot this tick
                plans[i] = (f, [])
                continue
            nodes = len(g_trees[i][0]) if g_trees[i] is not None else 0
            walk: List[int] = []
            accepted = g = 0
            for v in range(cnts[i]):
                col = path[i][v]
                tok = grid[i][col]
                self._check(finite[i][col], tok,
                            f"slot {i} (request {slot.request_id}): "
                            "tree verify")
                walk.append(tok)
                if v:
                    accepted += 1
                    if g == v - 1 and col == f - 1 + v:
                        g += 1    # the walk stayed on the leftmost chain
                if tok == self.eos_id or len(slot.generated) + len(walk) \
                        >= slot.request.max_new_tokens:
                    break
            # rows: the forced chain plus the contiguous accepted run
            # (the last committed sample has no row yet: it is the next
            # pending token, as in the linear walk)
            plans[i] = (f + g, walk)
            new_tok_max = max(new_tok_max, len(walk))
            self.tokens_drafted += nodes
            self.tokens_accepted += accepted
            if eng.adaptive_spec and nodes:
                self._accept_ewma[i] = 0.5 * self._accept_ewma[i] \
                    + 0.5 * accepted / nodes
        counts = [0] * eng.num_slots
        for i, (rows, walk) in plans.items():
            for tok in walk:
                self._append(i, tok)
            self._slots[i].pos += rows
            counts[i] = rows
        eng.commit(counts)
        self.spec_ticks += 1
        if new_tok_max > 1:
            self._tick_no += new_tok_max - 1
        for i, (rows, _) in plans.items():
            if rows:
                self._maybe_evict(i)
        return k1 * len(forced)

    @property
    def busy(self) -> bool:
        """Work pending: queued requests or occupied slots."""
        return bool(self._queue) or any(s is not None for s in self._slots)

    def step(self) -> None:
        """One scheduler tick: admit into free slots, then decode (or
        verify)."""
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

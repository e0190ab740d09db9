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

Failure is an expected state (``serving.health``): pool exhaustion,
non-finite logits, bad samples and transient exec faults degrade
instead of crashing or spinning, as in the JAX scheduler:

- every committed token passes two always-on gates: its logits row is
  finite and the sampled id is inside the vocabulary. A slot that fails
  one is QUARANTINED — the corrupt token is never committed, the slot
  is freed and its request requeued at the queue front with its
  progress; the resumed stream is the fault-free one, and co-tenant
  slots never notice. Each fault-path requeue (a quarantine, an
  injected prefill or chunk fault) charges the request's retry budget
  (``max_retries``); exhausting it ends the request with a
  :class:`~apex_tpu_torch.serving.health.RetryBudgetExhausted`.
  Capacity preemptions charge nothing.
- ``max_queue`` bounds the admission queue (``submit`` raises
  :class:`~apex_tpu_torch.serving.health.AdmissionRejected` past it);
  ``Request.deadline_ticks`` bounds a request's lifetime in ticks
  (:class:`~apex_tpu_torch.serving.health.DeadlineExceeded` with the
  tokens committed so far).
- the watchdog raises :class:`~apex_tpu_torch.serving.health.
  LivelockError` (the stuck requests and a pool snapshot) after
  ``watchdog_limit`` ticks without a committed token, a finished
  request, a retry or a prefill chunk; ``audit=True`` runs the engine's
  invariant check after every tick.

The fault injector (``serving.faults``, the engine's ``injector=``)
drives these paths deterministically at the named host-side sites, so a
chaos run replays its faults, streams and tick-clock events exactly.

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

Chunked prefill (``chunk_tokens=``, the Sarathi-Serve move): a
monolithic prompt forward stalls every co-tenant decode for the whole
prompt, which is what blows up the tail of inter-token latency under
mixed prompt/decode load. With chunking on, admission only STAGES a
prefill (on the paged engine its pages are allocated up front, all or
nothing); each tick then runs the decode step first and spends what
remains of ``tick_token_budget`` on prompt chunks of ``chunk_tokens``
(at least one chunk a tick, the concurrent prefills round-robined one
chunk at a time in request order). A mid-prefill slot is invisible to
the decode path, and on the paged cache its block-table row stays parked
on scratch until the final chunk installs it. The final chunk's logits
are the monolithic prefill's first-token logits, sampled with the same
key, so the committed streams are the monolithic scheduler's: chunking
only moves when prompt work runs.

The tick clock (``clock``): every forward advances it by the sequential
depth it covers (a decode tick 1, a verify tick that commits m tokens m,
a prefill of S tokens S, a chunk its length), so a monolithic S-token
prefill opens an S-tick gap in co-tenant streams and a chunked one at
most about the tick token budget. ``submit(..., at_tick=)`` backdates an
open-loop arrival and ``advance_clock`` jumps an idle scheduler to the
next one. Outcomes carry TTFT, total and prefill ticks; with an enabled
:class:`~apex_tpu_torch.serving.observe.Tracer` on the engine
(``tracer=``) every phase is a span and every lifecycle step an instant,
and the TTFT and inter-token gaps land in the tracer's histograms
(``latency_summary``). The engine's counters are one
:class:`~apex_tpu_torch.serving.health.ServingStats` (``engine.stats``,
shared as ``scheduler.stats``), a view over the tracer's registry.

Tenancy (``tenancy=``, ``serving.tenancy``) picks which queued request
to admit (priority rung, then the tenant's stride-clock vtime), defers
admissions a tenant's page quota cannot cover, lets a higher rung
requeue a resident lower one, and checks each finished request against
its tenant's SLO bounds; it moves WHEN work runs, never WHAT commits.
``streams=True`` (``serving.streaming``) delivers each request's
committed tokens at the end of every tick; a dropped delivery (the
``stream_emit`` site) closes that stream, its delivered tokens a strict
prefix of the committed ones.

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
    NULL_PAGE, RESERVED_PAGES, SCRATCH_PAGE, PagedKVCache,
    audit_block_tables, init_cache, init_paged_cache, max_pages_per_slot,
)
from apex_tpu_torch.serving.decode import (
    make_chunk_prefill_fn, make_copy_page_fn, make_decode_fn,
    make_paged_chunk_prefill_fn, make_paged_decode_fn, make_paged_prefill_fn,
    make_paged_tree_verify_fn, make_paged_verify_fn, make_prefill_fn,
    make_tree_verify_fn, make_verify_fn,
)
from apex_tpu_torch.serving.draft import ngram_draft, tree_arrays
from apex_tpu_torch.serving.faults import FaultInjector, InjectedFault
from apex_tpu_torch.serving.health import (
    AdmissionRejected, DeadlineExceeded, LivelockError, NonFiniteLogits,
    PoolExhausted, PromoteFailed, QuotaExhausted, RequestOutcome,
    RetryBudgetExhausted, ServingStats,
)
from apex_tpu_torch.serving.observe import Tracer
from apex_tpu_torch.serving.paging import (
    PAGE_KEY_VERSION, SPILL_DTYPE_TAGS, PagePool, PrefixRegistry,
    SpillRecord, decode_spill_header, encode_spill_header, prefix_page_keys,
    spill_checksum,
)
from apex_tpu_torch.serving.sampling import (
    finite_rows, sample_token_grid, sample_tokens, tree_speculative_accept,
)
from apex_tpu_torch.serving.streaming import StreamMux
from apex_tpu_torch.serving.transfer import (
    _host, make_extract_pages_fn, make_extract_pages_quant_fn,
    make_insert_pages_fn, make_insert_pages_quant_fn,
)
from apex_tpu_torch.utils import prng
from apex_tpu_torch.utils.platform import DeviceLike, resolve_device
from apex_tpu_torch.utils.seqlen import (
    bucket_for, default_buckets, pad_to_bucket,
)


@dataclasses.dataclass(frozen=True)
class Request:
    """One generation request. ``temperature <= 0`` means greedy;
    ``seed`` roots a sampled request's random stream. ``deadline_ticks``,
    when set, bounds the request's lifetime in scheduler ticks since
    submission (an overrun ends in a ``deadline`` outcome with the
    tokens committed so far). ``tenant_id`` names the traffic class the
    tenancy front-end (``serving.tenancy``) accounts the request under;
    the default tenant keeps an untenanted scheduler as it is."""
    prompt: Tuple[int, ...]
    max_new_tokens: int = 16
    temperature: float = 0.0
    seed: int = 0
    deadline_ticks: Optional[int] = None
    tenant_id: str = "default"


@dataclasses.dataclass
class _PrefillProgress:
    """A slot's chunked prefill in flight: the whole teacher-forcing
    sequence, the next chunk's start, and the engine's opaque staging
    state from ``begin_chunk_prefill`` (page plan, prefix keys). While
    ``_Slot.prefill`` holds one the slot owns cache capacity but the
    decode path does not see it."""
    tokens: Tuple[int, ...]
    next: int
    state: Dict


@dataclasses.dataclass
class _Slot:
    request_id: int
    request: Request
    prompt_len: int
    generated: List[int]
    pos: int            # cache rows written (prompt + decode steps)
    prefill: Optional[_PrefillProgress] = None


class DecodeEngine:
    """Owns the params, the cache and the prefill/decode/verify steps.
    Params must already lie on ``device`` (``None`` means the card). A
    weight-only int8 tree (``quant.quantize_params``) is detected and
    served through the w8 kernels; ``compute_dtype`` is then the
    activations' dtype (fp32 with None), as in the JAX engine.
    ``top_k`` / ``top_p`` restrict every sampled row (0 = off).
    ``spec_k`` is the draft depth (0: no speculation); ``draft_model``
    (a :class:`~apex_tpu_torch.serving.draft_model.DraftModel`),
    ``tree_spec`` and ``adaptive_spec`` need ``spec_k >= 1``.
    ``injector`` hooks the fault sites (``serving.faults``; inert by
    default, one dict lookup and one increment a site visit);
    ``tracer`` hooks the observability sites (``serving.observe``;
    disabled by default, one attribute check a site); ``stats`` is the
    :class:`~apex_tpu_torch.serving.health.ServingStats` counter block
    the scheduler shares, a view over the tracer's registry."""

    paged = False
    #: The tenant whose request the scheduler is admitting, stamped (with
    #: tenancy on) just before ``prefill`` / ``begin_chunk_prefill``.
    admission_tenant: Optional[str] = None

    def __init__(self, params, cfg: GPTConfig, num_slots: int,
                 max_len: int, cache_dtype: torch.dtype = torch.bfloat16,
                 top_k: int = 0, top_p: float = 0.0, spec_k: int = 0,
                 buckets: Optional[Sequence[int]] = None,
                 compute_dtype: Optional[torch.dtype] = None,
                 injector: Optional[FaultInjector] = None,
                 draft_model=None, tree_spec: bool = False,
                 adaptive_spec: bool = False,
                 tracer: Optional[Tracer] = None,
                 device: DeviceLike = None):
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
        self.injector = injector or FaultInjector()
        self.tracer = tracer if tracer is not None else Tracer(enabled=False)
        self.stats = ServingStats(registry=self.tracer.registry)
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
        self._chunk_prefill = make_chunk_prefill_fn(cfg, compute_dtype,
                                                    quantized)
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
        the last-real-token logits (1, V). An armed ``prefill_exec``
        fault site raises :class:`~apex_tpu_torch.serving.faults.
        InjectedFault` before the forward."""
        self._fault("prefill_exec")
        ids = torch.tensor([list(prompt)], dtype=torch.int64,
                           device=self.device)
        ids, mask = pad_to_bucket(ids, ids.shape[1], buckets=self.buckets)
        trc = self.tracer
        if trc.enabled:
            trc.begin("prefill")
        self.cache, logits = self._prefill(self.params, self.cache, ids,
                                           mask, slot)
        if trc.enabled:
            trc.end("prefill", slot=slot, bucket=int(ids.shape[1]))
        return logits

    # -- chunked prefill ------------------------------------------------

    def begin_chunk_prefill(self, slot: int, prompt: Sequence[int]) -> Dict:
        """Stage a chunked prefill of ``prompt`` into ``slot``; returns
        the opaque state :meth:`chunk_prefill` takes. The dense cache's
        rows belong to their slot, so it only carries the first chunk's
        start."""
        if len(prompt) > self.max_len:
            raise ValueError(
                f"prompt length {len(prompt)} exceeds cache max_len "
                f"{self.max_len}")
        return {"start": 0}

    def chunk_prefill(self, slot: int, chunk: Sequence[int], pos: int,
                      state: Dict, bucket: int,
                      final: bool) -> torch.Tensor:
        """Run ONE prompt chunk (rows ``pos .. pos + len(chunk) - 1``) of
        ``slot``, padded to ``bucket`` tokens. Returns the chunk's
        last-real-token logits (1, V); only the final chunk's feed the
        first sampled token. An armed ``chunk_prefill_exec`` fault site
        raises :class:`~apex_tpu_torch.serving.faults.InjectedFault`
        before touching the cache."""
        self._fault("chunk_prefill_exec")
        ids = torch.tensor([list(chunk)], dtype=torch.int64,
                           device=self.device)
        ids, mask = pad_to_bucket(ids, ids.shape[1], buckets=(bucket,))
        trc = self.tracer
        if trc.enabled:
            trc.begin("chunk_prefill")
        self.cache, logits = self._chunk_prefill(
            self.params, self.cache, ids, mask, slot, pos)
        if trc.enabled:
            trc.end("chunk_prefill", slot=slot, pos=pos, bucket=bucket,
                    final=final)
        return logits

    def finish_chunk_prefill(self, slot: int, state: Dict) -> None:
        """Bookkeeping after the final chunk (the paged engine registers
        the prompt's prefix); nothing for the dense cache."""

    def _fault(self, site: str) -> None:
        """Raise :class:`InjectedFault` when ``site``'s draw fires."""
        if self.injector.fire(site):
            raise InjectedFault(site, self.injector.calls(site) - 1)

    def _nan_row(self, logits: torch.Tensor) -> torch.Tensor:
        """The ``decode_exec`` site, drawn after a decode or verify step:
        when it fires, one victim slot's logits (every position of a
        verify step) become NaN; the other rows keep their bits."""
        fired, payload = self.injector.draw("decode_exec")
        if fired:
            logits[int(payload % logits.shape[0])] = float("nan")
        return logits

    def _bad_sample(self, toks: torch.Tensor) -> torch.Tensor:
        """The ``sample`` site: when it fires, one victim slot's token
        (its first position on a verify grid) becomes an
        out-of-vocabulary id, negative so it never collides with a real
        token."""
        fired, payload = self.injector.draw("sample")
        if fired:
            victim = int(payload % toks.shape[0])
            toks[(victim,) + (0,) * (toks.dim() - 1)] = -1 - payload % 7
        return toks

    def decode(self, tokens: Sequence[int],
               active: Sequence[bool]) -> torch.Tensor:
        """One token for every slot; ``active`` gates the length
        advance. Returns (num_slots, V) fp32 logits, through the
        ``decode_exec`` fault site (:meth:`_nan_row`)."""
        tok = torch.tensor(list(tokens), dtype=torch.int64,
                           device=self.device)
        act = torch.tensor(list(active), dtype=torch.bool,
                           device=self.device)
        trc = self.tracer
        if trc.enabled:
            trc.begin("exec")
        self.cache, logits = self._decode(self.params, self.cache, tok, act)
        if trc.enabled:
            trc.end("exec", kind="decode")
        return self._nan_row(logits)

    def sample(self, logits: torch.Tensor, keys,
               temperature: Sequence[float]) -> torch.Tensor:
        """(B,) int32 tokens; ``keys`` (B, 2) and ``temperature`` (B,)
        on the host. A batch of greedy rows only takes the argmax and
        draws nothing. Through the ``sample`` fault site
        (:meth:`_bad_sample`)."""
        if max(temperature) <= 0:
            toks = torch.argmax(logits, dim=-1).to(torch.int32)
        else:
            toks = sample_tokens(logits, keys, torch.tensor(
                list(temperature), dtype=torch.float32,
                device=logits.device), self.top_k, self.top_p)
        return self._bad_sample(toks)

    def finite(self, logits: torch.Tensor) -> torch.Tensor:
        """(B,) bool (or (B, k1) for a verify step's logits): which rows
        are safe to sample."""
        return finite_rows(logits)

    # -- speculative decoding -------------------------------------------

    def draft(self, history: Sequence[int]) -> List[int]:
        """Host-side n-gram draft of up to ``spec_k`` candidates from
        one slot's prompt + generated history. An armed ``draft_exec``
        fault site raises :class:`InjectedFault`: the scheduler degrades
        that slot to an empty draft for the tick, charging no retry."""
        self._fault("draft_exec")
        return ngram_draft(history, self.spec_k)

    def _draft_ladder(self) -> bool:
        """The model drafter's two-rung ``draft_exec`` ladder: one draw
        decides whether the MODEL draft fails this tick; a fired draw
        counts a draft fault and takes a second draw deciding whether
        the n-gram fallback fails too (raising :class:`InjectedFault`,
        which the scheduler turns into a plain tick). Returns True when
        the caller should use the n-gram rung. No rung charges retry
        budget."""
        if not self.injector.fire("draft_exec"):
            return False
        self.stats.draft_faults += 1
        self._fault("draft_exec")
        return True

    def draft_batch(self, histories, ks) -> List[List[int]]:
        """Model-draft every slot in one batched call: up to ``ks[i]``
        greedy continuation tokens of ``histories[i]`` from the attached
        :class:`~apex_tpu_torch.serving.draft_model.DraftModel` (a
        ``None`` history or ``k = 0`` yields an empty draft). The
        ``draft_exec`` ladder (:meth:`_draft_ladder`) degrades model ->
        n-gram -> plain."""
        if self._draft_ladder():
            return [list(ngram_draft(h, k)) if h is not None else []
                    for h, k in zip(histories, ks)]
        return [[int(t) for t in c]
                for c in self.draft_model.draft(histories, ks)]

    def draft_tree_batch(self, histories, ks):
        """Tree drafts (``(tokens, parents)`` a slot, ``None`` when
        inactive) from the model drafter: a greedy chain plus an
        alternate root branch (:meth:`DraftModel.draft_tree`). The same
        ``draft_exec`` ladder; its n-gram rung gives single-chain
        trees."""
        if self._draft_ladder():
            out = []
            for h, k in zip(histories, ks):
                c = [int(t) for t in ngram_draft(h, k)] \
                    if h is not None else []
                out.append((c, [-1] + list(range(len(c) - 1)))
                           if c else None)
            return out
        return self.draft_model.draft_tree(histories, ks)

    def verify(self, tokens) -> torch.Tensor:
        """One speculative verify step: ``tokens`` (num_slots, k1) —
        column 0 the pending token, columns 1.. the (0-padded) drafts.
        Returns (num_slots, k1, V) fp32 logits; the lengths advance
        separately (:meth:`commit`) once the accept walk knows each
        slot's count."""
        tok = self._ids(tokens)
        trc = self.tracer
        if trc.enabled:
            trc.begin("exec")
        self.cache, logits = self._verify(self.params, self.cache, tok)
        if trc.enabled:
            trc.end("exec", kind="verify", k1=int(tok.shape[1]))
        return self._nan_row(logits)

    def tree_verify(self, tokens, depth, anc) -> torch.Tensor:
        """One tree-attention verify step over a packed draft grid
        (:func:`~apex_tpu_torch.serving.draft.tree_arrays`): column j
        writes its row at ``lengths + j``, takes position ``lengths +
        depth[:, j]`` and sees the committed rows and its ancestors
        under ``anc``. Returns (num_slots, k1, V) fp32 logits."""
        tok = self._ids(tokens)
        trc = self.tracer
        if trc.enabled:
            trc.begin("exec")
        self.cache, logits = self._tree_verify(
            self.params, self.cache, tok, self._ids(depth),
            self._ids(anc, torch.bool))
        if trc.enabled:
            trc.end("exec", kind="tree_verify", k1=int(tok.shape[1]))
        return self._nan_row(logits)

    def commit(self, counts: Sequence[int]) -> None:
        """Advance slot lengths by each slot's committed row count — the
        host half of the verify step's rollback: rows past ``lengths +
        count`` were written but no mask admits them before a later
        step rewrites them."""
        trc = self.tracer
        if trc.enabled:
            trc.begin("commit")
        self.cache.lengths.add_(self._ids(counts, torch.int32))
        if trc.enabled:
            trc.end("commit", rows=int(sum(int(c) for c in counts)))

    def sample_grid(self, logits: torch.Tensor, keys,
                    temperature: Sequence[float]) -> torch.Tensor:
        """Sample every (slot, position) of a verify step's logits
        (B, k1, V) with its own key (keys (B, k1, 2)); (B, k1) int32. A
        greedy-only batch takes the argmax and draws nothing. The
        ``sample`` fault site corrupts the victim slot's FIRST position
        (the one a plain tick would have drawn)."""
        if max(temperature) <= 0:
            toks = torch.argmax(logits, dim=-1).to(torch.int32)
        else:
            toks = sample_token_grid(logits, keys, torch.tensor(
                list(temperature), dtype=torch.float32,
                device=logits.device), self.top_k, self.top_p)
        return self._bad_sample(toks)

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
    ``stats.cow_copies``, ``stats.preemptions`` and
    ``stats.pool_exhausted`` count the copy-on-write clones, the
    preemptions and the admissions the pool refused.

    ``host_tier`` (a :class:`~apex_tpu_torch.serving.paging.
    PrefixRegistry`) catches the prefix pages the pool evicts and
    promotes them back at admission, each promotion charged
    ``promote_ticks_per_page`` on the admission clock; the ``stats``
    fields ``host_spills``, ``host_spill_bytes``, ``host_promotes``,
    ``host_promote_bytes``, ``host_promote_ticks``,
    ``host_spill_failures`` and ``host_promote_failures`` count its
    traffic. Tree speculation is refused over the int8 pool, as in the
    JAX engine. ``injector`` also hooks the pool's ``pool_alloc`` site,
    the ``cow_clone`` site of :meth:`prepare_decode` and the host tier's
    ``host_spill`` and ``host_promote`` sites."""

    paged = True

    def __init__(self, params, cfg: GPTConfig, num_slots: int,
                 max_len: int, num_pages: int, page_size: int,
                 cache_dtype: torch.dtype = torch.bfloat16, top_k: int = 0,
                 top_p: float = 0.0, spec_k: int = 0,
                 buckets: Optional[Sequence[int]] = None,
                 compute_dtype: Optional[torch.dtype] = None,
                 free_order: Optional[Sequence[int]] = None,
                 prefix_sharing: bool = True,
                 injector: Optional[FaultInjector] = None,
                 draft_model=None, tree_spec: bool = False,
                 adaptive_spec: bool = False,
                 tracer: Optional[Tracer] = None,
                 host_tier: Optional[PrefixRegistry] = None,
                 promote_ticks_per_page: float = 0.125,
                 device: DeviceLike = None):
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
        self.injector = injector or FaultInjector()
        self.tracer = tracer if tracer is not None else Tracer(enabled=False)
        self.stats = ServingStats(registry=self.tracer.registry)
        self.cache = self._make_cache(num_pages, cache_dtype)
        self.pool = PagePool(num_pages, page_size, free_order,
                             injector=self.injector, host_tier=host_tier)
        # the host spill tier: the pool's eviction sweep calls
        # _spill_page for pages the prefix registry alone holds; an
        # admission's registry miss promotes records back
        # (_promote_chain) and its clock charge is repriced at the
        # suffix's depth plus the promote ticks (pop_admit_charge)
        self.host_tier = host_tier
        self.promote_ticks_per_page = float(promote_ticks_per_page)
        self._admit_extra = 0
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
        # slots mid chunked prefill: their device block-table row is
        # parked on scratch (begin_chunk_prefill), so the audit expects
        # it empty rather than mirroring _slot_pages
        self._prefill_parked: set = set()
        self._make_steps(compute_dtype, is_quantized_tree(params))

    def _make_cache(self, num_pages: int,
                    cache_dtype: torch.dtype) -> PagedKVCache:
        """The page pool and block tables on ``self.device``."""
        return init_paged_cache(self.cfg, self.num_slots, self.max_len,
                                num_pages, self.page_size, cache_dtype,
                                self.device)

    def _make_steps(self, compute_dtype: Optional[torch.dtype],
                    quantized: bool) -> None:
        """The device steps: prefill, chunk prefill, decode, verify, tree
        verify (with ``tree_spec``) and the copy-on-write page copy."""
        cfg = self.cfg
        self._prefill = make_paged_prefill_fn(cfg, compute_dtype,
                                              quantized)
        self._chunk_prefill = make_paged_chunk_prefill_fn(
            cfg, compute_dtype, quantized)
        self._decode = make_paged_decode_fn(cfg, compute_dtype, quantized)
        self._verify = make_paged_verify_fn(cfg, compute_dtype, quantized)
        self._tree_verify = make_paged_tree_verify_fn(
            cfg, compute_dtype, quantized) if self.tree_spec else None
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
        leading pages are skipped: the suffix runs as the one final
        chunk of a chunked prefill, attending the covered pages through
        the real row (an int8 pool keeps the whole forward). Raises
        :class:`PoolExhausted` when the pool cannot cover the prompt
        even after LRU eviction, and :class:`InjectedFault` under an
        armed ``prefill_exec`` site; both release every page reference
        taken first. ``ValueError`` for a prompt beyond ``max_len``
        before touching the pool."""
        state = self.begin_chunk_prefill(slot, prompt)
        if self.injector.fire("prefill_exec"):
            # roll back the claim; the slot's device row was never set
            self._admit_extra -= state["promote_ticks"]
            for q in self._slot_pages[slot]:
                self.pool.release(q)
            self._slot_pages[slot] = []
            self._prefill_parked.discard(slot)
            raise InjectedFault("prefill_exec",
                                self.injector.calls("prefill_exec") - 1)
        toks, start = state["tokens"], state["start"]
        trc = self.tracer
        if trc.enabled:
            trc.begin("prefill")
        if self.host_tier is not None and start \
                and self.cache.k_scale is None:
            bucket = bucket_for(len(toks) - start, self.buckets)
            logits = self._run_chunk(slot, toks[start:], start, state,
                                     bucket, final=True)
            # the forward ran the suffix's depth only
            self._admit_extra -= start
        else:
            self._prefill_parked.discard(slot)
            ids = torch.tensor([toks], dtype=torch.int64,
                               device=self.device)
            ids, mask = pad_to_bucket(ids, ids.shape[1],
                                      buckets=self.buckets)
            bucket = int(ids.shape[1])
            write = np.full((bucket // self.page_size,), SCRATCH_PAGE,
                            np.int32)
            write[state["shared"]:state["n_pages"]] = \
                state["pages"][state["shared"]:]
            self.cache, logits = self._prefill(
                self.params, self.cache, ids, mask, slot,
                self._ids(write, torch.int32),
                self._ids(state["row"], torch.int32))
        if trc.enabled:
            trc.end("prefill", slot=slot, bucket=bucket,
                    shared_pages=state["shared"])
        self.finish_chunk_prefill(slot, state)
        return logits

    def _claim_pages(self, slot: int, prompt: Sequence[int]):
        """An admission's pages: the longest cached prefix run, the next
        links of the chain promoted from the host tier, private pages for
        the rest — all or nothing: :class:`PoolExhausted` when the pool
        cannot cover the prompt after LRU eviction, every reference taken
        released first; ``ValueError`` for a prompt beyond ``max_len``
        before touching the pool. The pages become the slot's. Returns
        ``(tokens, prefix keys, pages, covered, promote ticks)``: the
        first ``covered`` pages are shared or promoted."""
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
        return toks, keys, pages, covered, promote_ticks

    # -- chunked prefill ------------------------------------------------

    def begin_chunk_prefill(self, slot: int, prompt: Sequence[int]) -> Dict:
        """Stage a chunked prefill: share the longest cached prefix run,
        promote host-tier links, and allocate the private pages UP FRONT
        (all or nothing, rolled back as :meth:`prefill` rolls back), but
        run no forward yet. While chunks are in flight the slot's device
        block-table row stays parked on scratch: co-tenant decode and
        verify steps write a garbage row for EVERY slot, and a
        mid-prefill slot's write target could be a shared page. Fully
        covered leading pages are skipped (their rows are reused as they
        are); the last page always runs, so the final chunk yields the
        first-token logits."""
        toks, keys, pages, covered, promote_ticks = self._claim_pages(
            slot, prompt)
        n_pages = len(pages)
        self._prefill_parked.add(slot)
        # promotions cost transfer ticks, added to the admission's next
        # charge (several staged prefills may promote before one)
        self._admit_extra += promote_ticks
        row = np.full((self.max_pages,), NULL_PAGE, np.int32)
        row[:n_pages] = pages
        skip = min(covered, max(n_pages - 1, 0))
        return {"tokens": toks, "keys": keys, "pages": pages,
                "shared": covered, "n_pages": n_pages, "row": row,
                "start": skip * self.page_size,
                "promote_ticks": promote_ticks}

    def chunk_prefill(self, slot: int, chunk: Sequence[int], pos: int,
                      state: Dict, bucket: int,
                      final: bool) -> torch.Tensor:
        """Run one page-aligned prompt chunk of ``slot``: its rows write
        whole private pages (shared and past-the-prompt pages go to
        scratch) while attention gathers through the real NULL-padded
        row, so earlier chunks' pages and the shared prefix are visible.
        The final chunk also installs the real block-table row, ending
        the parking. An armed ``chunk_prefill_exec`` site raises
        :class:`InjectedFault` before touching the cache; the caller
        frees the slot, which releases every staged page."""
        self._fault("chunk_prefill_exec")
        trc = self.tracer
        if trc.enabled:
            trc.begin("chunk_prefill")
        logits = self._run_chunk(slot, chunk, pos, state, bucket, final)
        if trc.enabled:
            trc.end("chunk_prefill", slot=slot, pos=pos, bucket=bucket,
                    final=final, shared_pages=state["shared"])
        return logits

    def _run_chunk(self, slot: int, chunk: Sequence[int], pos: int,
                   state: Dict, bucket: int, final: bool) -> torch.Tensor:
        """The chunk forward of :meth:`chunk_prefill`, untraced."""
        ids = torch.tensor([list(chunk)], dtype=torch.int64,
                           device=self.device)
        ids, mask = pad_to_bucket(ids, ids.shape[1], buckets=(bucket,))
        first_page = pos // self.page_size
        write = np.full((bucket // self.page_size,), SCRATCH_PAGE, np.int32)
        for j in range(write.shape[0]):
            if state["shared"] <= first_page + j < state["n_pages"]:
                write[j] = state["pages"][first_page + j]
        if final:
            store = state["row"]
            self._prefill_parked.discard(slot)
        else:
            store = np.full((self.max_pages,), SCRATCH_PAGE, np.int32)
        self.cache, logits = self._chunk_prefill(
            self.params, self.cache, ids, mask, slot, pos,
            self._ids(write, torch.int32), self._ids(state["row"],
                                                     torch.int32),
            self._ids(store, torch.int32))
        return logits

    def finish_chunk_prefill(self, slot: int, state: Dict) -> None:
        """Register the prompt's prefix chain for later admissions, as
        the monolithic prefill does."""
        if self.prefix_sharing:
            self.pool.register_prefix(state["keys"], state["pages"])

    def pop_admit_charge(self, default: int) -> int:
        """Pop the staged admission charge: the forward's depth
        ``default`` plus the promote ticks staged since the last charge,
        less the covered rows a host-tier prefill skipped."""
        extra, self._admit_extra = self._admit_extra, 0
        return default + extra

    def _spill_page(self, key: bytes, page: int) -> None:
        """Pool eviction hook: copy ``page`` (held by the prefix registry
        alone, so its content is pristine — copy-on-write guarantees no
        slot appended to it) out to the host tier under its chain key.
        A fired ``host_spill`` site drops the spill: the prefix leaves
        both tiers and a later admission re-prefills it."""
        if self.injector.fire("host_spill"):
            self.stats.host_spill_failures += 1
            if self.tracer.enabled:
                self.tracer.instant("host_spill", page=page, ok=False)
            return
        tiles = [_host(t) for t in self._tier_extract(self.cache,
                                                           [page])]
        k, v = tiles[:2]
        ks, vs = (tiles[2], tiles[3]) if len(tiles) == 4 else (None, None)
        header = encode_spill_header(key, *self._spill_geometry)
        rec = SpillRecord(header, k, v, ks, vs,
                          spill_checksum(header, k, v, ks, vs))
        if self.host_tier.put(key, rec):
            self.stats.host_spills += 1
            self.stats.host_spill_bytes += rec.nbytes
            if self.tracer.enabled:
                self.tracer.instant("host_spill", page=page,
                                    bytes=rec.nbytes)

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
        breaks at the first miss, fired ``host_promote`` site, failed
        verification (the stale record is dropped) or pool exhaustion;
        a fault or failed verification is counted. Pages promoted so far
        are kept and the rest of the prompt re-prefills. Returns
        ``(pages, ticks)``; the caller owns one reference a page and
        charges ``ticks`` on the admission clock."""
        pages: List[int] = []
        records: List[SpillRecord] = []
        failed: Optional[PromoteFailed] = None
        for key in keys[start:]:
            rec = self.host_tier.get(key)
            if rec is None:
                break
            if self.injector.fire("host_promote"):
                failed = PromoteFailed("injected host_promote fault",
                                       key=key.hex(), pages=len(pages))
                break
            try:
                self._verify_spill(key, rec)
            except PromoteFailed as e:
                self.host_tier.drop(key)
                failed = e
                break
            p = self.pool.alloc()
            if p is None:
                break
            pages.append(p)
            records.append(rec)
        if failed is not None:
            self.stats.host_promote_failures += 1
            if self.tracer.enabled:
                self.tracer.instant("host_promote", ok=False,
                                    pages=len(pages))
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
        nbytes = sum(r.nbytes for r in records)
        self.stats.host_promotes += len(pages)
        self.stats.host_promote_bytes += nbytes
        self.stats.host_promote_ticks += ticks
        if self.tracer.enabled:
            self.tracer.instant("host_promote", pages=len(pages),
                                bytes=nbytes, ticks=ticks)
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
        private and reused. A slot the pool cannot serve (or whose
        ``cow_clone`` fault site fired) is preempted: its pages are
        released (often unblocking the rest of the batch) and the caller
        requeues its request. Returns the preempted slots."""
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
                    dst = None if self.injector.fire("cow_clone") \
                        else self.pool.alloc()
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
                    self.stats.cow_copies += 1
                    self.cache = self._copy(self.cache, pages[idx], dst)
                    self.cache.block_tables[i, idx] = dst
                    self.pool.release(pages[idx])
                    pages[idx] = dst
        return preempted

    def _preempt(self, slot: int, preempted: List[int]) -> None:
        self.free_slot(slot)
        self.stats.preemptions += 1
        preempted.append(slot)

    def free_slot(self, slot: int) -> None:
        """Release the slot's page references and park its block-table
        row on scratch (a freed slot's writes must never land in a page
        the allocator may hand to someone else)."""
        for p in self._slot_pages[slot]:
            self.pool.release(p)
        self._slot_pages[slot] = []
        self._prefill_parked.discard(slot)
        self.cache.block_tables[slot] = SCRATCH_PAGE
        if self.draft_model is not None:
            self.draft_model.free_slot(slot)

    def check_invariants(self) -> bool:
        """Full pool audit: the host refcounts, free list and registry
        against the per-slot page lists
        (:meth:`~apex_tpu_torch.serving.paging.PagePool.check_invariants`),
        then the device block tables against the same lists
        (:func:`~apex_tpu_torch.serving.cache.audit_block_tables`).
        A slot mid chunked prefill holds its pages but parks its device
        row on scratch until the final chunk, so its row is audited as
        empty. Raises
        :class:`~apex_tpu_torch.serving.health.PoolInvariantError`."""
        self.pool.check_invariants(self._slot_pages)
        expect = [[] if i in self._prefill_parked else p
                  for i, p in enumerate(self._slot_pages)]
        audit_block_tables(self.cache.block_tables, expect)
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
    """FIFO -> fixed slots -> batched decode (or verify) ticks, with the
    graceful-degradation layer (see the module doc): typed outcomes in
    ``self.outcomes``, the engine's counter block shared as
    ``self.stats`` (``plain_ticks``, ``spec_ticks``, ``tokens_drafted``,
    ``tokens_accepted``, ``prefill_chunks``, ``evictions``, ``retries``,
    ...; ``stats.acceptance_rate``), per-request retry budgets
    (``max_retries``), deterministic deadlines, a bounded admission queue
    (``max_queue``), a progress watchdog (``watchdog_limit``) and an
    optional per-tick invariant audit (``audit``). ``decode_steps``
    counts the batched decode and verify steps run. ``chunk_tokens``
    turns on chunked prefill under ``tick_token_budget`` tokens a tick
    (default: every slot's decode token plus one chunk). ``tenancy`` (a
    :class:`~apex_tpu_torch.serving.tenancy.TenancyPolicy`) adds weighted
    fair share, page quotas, priority preemption and SLOs; ``streams``
    (True, or a :class:`~apex_tpu_torch.serving.streaming.StreamMux`)
    delivers committed tokens per request at the end of every tick."""

    def __init__(self, engine: DecodeEngine, eos_id: int, *,
                 max_retries: int = 3, max_queue: Optional[int] = None,
                 watchdog_limit: int = 64, audit: bool = False,
                 chunk_tokens: Optional[int] = None,
                 tick_token_budget: Optional[int] = None,
                 tenancy=None, streams=None):
        self.engine = engine
        self.eos_id = eos_id
        self.max_retries = max_retries
        self.max_queue = max_queue
        self.watchdog_limit = watchdog_limit
        self.audit = audit
        if chunk_tokens is not None:
            chunk_tokens = int(chunk_tokens)
            if chunk_tokens < 1:
                raise ValueError(f"chunk_tokens must be >= 1, got "
                                 f"{chunk_tokens}")
            if engine.max_len % chunk_tokens:
                raise ValueError(
                    f"chunk_tokens {chunk_tokens} must divide the "
                    f"cache max_len {engine.max_len} (chunk starts "
                    "must never overrun the cache row)")
            if engine.paged and chunk_tokens % engine.page_size:
                raise ValueError(
                    f"paged chunks write whole pages: chunk_tokens "
                    f"{chunk_tokens} is not a multiple of page_size "
                    f"{engine.page_size}")
            if getattr(engine.cache, "k_scale", None) is not None:
                raise ValueError(
                    "chunked prefill is not offered over the int8 "
                    "page pool: incremental chunk writes would "
                    "re-round committed history at chunk-dependent "
                    "scales; kv8 keeps monolithic prefill")
        self.chunk_tokens = chunk_tokens
        if tick_token_budget is not None:
            tick_token_budget = int(tick_token_budget)
            if tick_token_budget < 1:
                raise ValueError(f"tick_token_budget must be >= 1, "
                                 f"got {tick_token_budget}")
        elif chunk_tokens is not None:
            # every decode slot's token plus one prefill chunk
            tick_token_budget = engine.num_slots + chunk_tokens
        self.tick_token_budget = tick_token_budget
        self.stats = engine.stats      # one counter block an engine
        self.tracer = engine.tracer    # and one tracer
        self.outcomes: Dict[int, RequestOutcome] = {}
        self._queue: deque = deque()
        self._slots: List[Optional[_Slot]] = [None] * engine.num_slots
        self._next_id = 0
        self._retries: Dict[int, int] = {}
        self._submit_tick: Dict[int, int] = {}
        # tick-clock latency bookkeeping (RequestOutcome's ticks and,
        # when tracing, the TTFT and inter-token histograms)
        self._first_token_tick: Dict[int, int] = {}
        self._last_token_tick: Dict[int, int] = {}
        # the ticks that ran prefill work for a request, across retries
        self._prefill_ticks: Dict[int, int] = {}
        self._tick_no = 0
        self._tokens_emitted = 0
        self.decode_steps = 0
        # the progress watchdog's state, held here so a load generator
        # can call step() directly
        self._stalled = 0
        self._watch_snap = None
        # adaptive controller: a slot's EWMA of its measured acceptance
        # (reset to 1.0 at admission); a slot converged to depth 0 gets
        # a probe draft every _probe_every ticks
        self._accept_ewma = [1.0] * engine.num_slots
        self._probe_every = 16
        # tenancy front-end (serving.tenancy): admission selection,
        # quotas, priority preemption, per-tenant SLOs; None keeps the
        # untenanted FIFO path as it is. The quota ledger hangs under
        # the engine's page pool, so the pool audit covers its books.
        self.tenancy = tenancy
        if tenancy is not None:
            if tenancy.needs_quota and not getattr(engine, "paged", False):
                raise ValueError(
                    "tenant page quotas price KV pages: they need a "
                    "paged engine (drop the quotas or use "
                    "PagedDecodeEngine)")
            pool = getattr(engine, "pool", None)
            if pool is not None:
                pool.ledger = tenancy.ledger
        # per-token streaming (serving.streaming): True builds a
        # StreamMux on the engine's injector, tracer and stats; a
        # StreamMux passed in keeps the caller's sink; None stages
        # nothing
        if streams is True:
            streams = StreamMux(injector=engine.injector,
                                tracer=engine.tracer, stats=engine.stats)
        self.streams = streams
        self._req_tenant: Dict[int, str] = {}
        # each request's worst inter-token gap (tenancy only: the ITL
        # SLO check at finish)
        self._max_itl: Dict[int, int] = {}

    @property
    def clock(self) -> int:
        """The work-charged tick clock (decode-step equivalents): every
        forward advances it by the sequential depth it covers, so an
        open-loop load generator can pace arrivals against it."""
        return self._tick_no

    def advance_clock(self, tick: int) -> None:
        """Fast-forward an idle scheduler's clock to ``tick`` (a no-op
        when already past it): a load generator jumps the quiet gaps
        between arrivals instead of spinning empty ticks through the
        watchdog."""
        self._tick_no = max(self._tick_no, int(tick))
        if self.tracer.enabled:
            self.tracer.set_tick(self._tick_no)

    def submit(self, request: Request, at_tick: Optional[int] = None) -> int:
        if self.max_queue is not None \
                and len(self._queue) >= self.max_queue:
            self.stats.admission_rejections += 1
            raise AdmissionRejected(
                f"admission queue is at its bound ({self.max_queue}); "
                "shed load and retry after completions")
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
        ten = self.tenancy
        if ten is not None:
            if not ten.has(request.tenant_id):
                raise ValueError(
                    f"unknown tenant {request.tenant_id!r}: declare it "
                    "in the TenancyPolicy before submitting under it")
            # the quota's fail-fast: a request whose worst-case
            # reservation can NEVER fit its tenant's quota is refused
            # here, not deferred forever at admission
            need = self._quota_need(request)
            if not ten.fits_quota(request.tenant_id, need):
                self.stats.quota_exhausted += 1
                raise QuotaExhausted(
                    f"request needs {need} pages worst-case but tenant "
                    f"{request.tenant_id!r} is capped at "
                    f"{ten.tenants[request.tenant_id].page_quota}",
                    tenant=request.tenant_id, need=need,
                    quota=ten.tenants[request.tenant_id].page_quota)
        rid = self._next_id
        self._next_id += 1
        self._req_tenant[rid] = request.tenant_id
        if ten is not None:
            # idle -> backlogged: a returning tenant's vtime is clamped
            # to the busy floor; one with work outstanding keeps its
            # fair-share deficit
            ten.note_enqueued(request.tenant_id)
        if self.streams is not None:
            self.streams.open(rid, request.tenant_id)
        # ``at_tick`` backdates an open-loop arrival: a charged forward
        # can move the clock PAST a request's arrival before the load
        # generator submits it, and the wait behind that forward must
        # still count in its TTFT and its deadline (or monolithic
        # prefill would hide the head-of-line blocking chunked prefill
        # is measured against)
        self._submit_tick[rid] = self._tick_no if at_tick is None \
            else min(int(at_tick), self._tick_no)
        if self.tracer.enabled:
            self.tracer.instant("submitted", request_id=rid,
                                prompt_len=len(request.prompt))
        # (id, request, tokens committed before a preemption or a
        # quarantine)
        self._queue.append((rid, request, []))
        return rid

    # -- typed termination ------------------------------------------------

    def _finish(self, rid: int, tokens: Sequence[int], reason: str,
                error=None) -> None:
        ttft = None
        if rid in self._first_token_tick:
            ttft = (self._first_token_tick[rid]
                    - self._submit_tick.get(rid, 0))
        total = self._tick_no - self._submit_tick.get(rid, self._tick_no)
        trc = self.tracer
        if trc.enabled:
            if error is not None:
                trc.attach(error)       # ship the flight-recorder ring
            trc.instant("finished", request_id=rid, reason=reason,
                        ok=error is None)
        tenant = self._req_tenant.get(rid, "default")
        ten = self.tenancy
        slo = None
        if ten is not None:
            # the one exit every request passes through: its quota
            # reservation is credited here and only here
            ten.credit(rid)
            ten.note_finished(tenant)
            slo = ten.slo_check(tenant, ttft, self._max_itl.get(rid))
            if slo is not None:
                self.stats.slo_violations += 1
                if trc.enabled:
                    trc.attach(slo)
                    trc.instant("slo_violation", request_id=rid,
                                tenant=tenant, metric=slo.metric,
                                observed=slo.observed, bound=slo.bound)
        if self.streams is not None:
            self.streams.finish(rid, reason)
        self.outcomes[rid] = RequestOutcome(
            tuple(int(t) for t in tokens), reason, error,
            retries=self._retries.get(rid, 0), ttft_ticks=ttft,
            total_ticks=total, prefill_ticks=self._prefill_ticks.get(rid),
            tenant_id=tenant, slo=slo)

    def _charge_work(self, tokens: int) -> None:
        """Advance the clock by a prefill forward's sequential depth: a
        forward that advances one stream by ``tokens`` positions costs
        that many ticks (a decode step one, so the tick itself pays the
        first). A monolithic S-token prefill opens an S-tick gap in
        co-tenant streams, a chunked one a gap bounded by the tick token
        budget. Accounting only: sampling keys fold in token counts,
        never ticks. The engine may reprice the charge
        (``pop_admit_charge``)."""
        tokens = self.engine.pop_admit_charge(tokens)
        if tokens > 1:
            self._tick_no += tokens - 1
            if self.tracer.enabled:
                self.tracer.set_tick(self._tick_no)

    def _note_token(self, rid: int, slot: int) -> None:
        """A committed token's tick-clock bookkeeping: the first stamps
        TTFT, a later one the inter-token gap (tokens of one multi-token
        speculative commit share a tick, so their gap is 0). With
        tenancy the token advances its tenant's stride clock; with
        streams it is staged for the end-of-tick flush."""
        tick = self._tick_no
        trc = self.tracer
        ten = self.tenancy
        if rid not in self._first_token_tick:
            self._first_token_tick[rid] = tick
            if trc.enabled:
                trc.instant("first_token", request_id=rid, slot=slot)
                trc.observe_ttft(tick - self._submit_tick.get(rid, tick))
                if ten is not None:
                    trc.observe_tenant_ttft(
                        self._req_tenant.get(rid, "default"),
                        tick - self._submit_tick.get(rid, tick))
        else:
            gap = tick - self._last_token_tick[rid]
            if ten is not None and gap > self._max_itl.get(rid, 0):
                self._max_itl[rid] = gap
            if trc.enabled:
                trc.observe_itl(gap)
                if ten is not None:
                    trc.observe_tenant_itl(
                        self._req_tenant.get(rid, "default"), gap)
        self._last_token_tick[rid] = tick
        if ten is not None:
            # stride clock: a committed token advances the tenant's
            # virtual time by 1 / weight
            ten.charge_tokens(self._req_tenant.get(rid, "default"), 1)
        if self.streams is not None:
            self.streams.stage(rid, self._slots[slot].generated[-1])

    def _append(self, i: int, tok: int) -> None:
        slot = self._slots[i]
        slot.generated.append(tok)
        self._tokens_emitted += 1
        self._note_token(slot.request_id, i)

    def _charge_retry(self, rid: int) -> bool:
        """Consume one unit of ``rid``'s retry budget; True when the
        budget is now exhausted (the caller must terminate it)."""
        if self.tracer.enabled:
            self.tracer.instant("retried", request_id=rid)
        self.stats.retries += 1
        n = self._retries.get(rid, 0) + 1
        self._retries[rid] = n
        return n > self.max_retries

    def _budget_error(self, rid: int, cause) -> RetryBudgetExhausted:
        return RetryBudgetExhausted(
            f"request {rid}: retry budget ({self.max_retries}) "
            f"exhausted; last fault: {cause}", request_id=rid,
            retries=self._retries.get(rid, 0))

    def _quarantine(self, i: int, err: NonFiniteLogits) -> None:
        """Free a slot whose tick output was corrupt; retry the request
        from its committed tokens (requeued at the FRONT: the resumed
        stream is the uncontended one) or, with the budget gone,
        terminate it typed."""
        s = self._slots[i]
        if self.tracer.enabled:
            self.tracer.instant("quarantined", request_id=s.request_id,
                                slot=i, cause=str(err))
        self._slots[i] = None
        self.engine.free_slot(i)
        rid = s.request_id
        if self._charge_retry(rid):
            self._finish(rid, s.generated, "retry_budget",
                         self._budget_error(rid, err))
        else:
            self._queue.appendleft((rid, s.request, list(s.generated)))

    def _quarantine_all(self, quarantined) -> None:
        """Quarantine AFTER the healthy slots commit, requeueing at the
        front in submission order (the preemption rule)."""
        for i, err in sorted(quarantined,
                             key=lambda t: self._slots[t[0]].request_id,
                             reverse=True):
            self._quarantine(i, err)

    def _expire_deadlines(self) -> None:
        def expired(req: Request, rid: int) -> bool:
            return (req.deadline_ticks is not None
                    and self._tick_no - self._submit_tick.get(rid, 0)
                    >= req.deadline_ticks)

        if any(expired(req, rid) for rid, req, _ in self._queue):
            keep: deque = deque()
            for rid, req, resume in self._queue:
                if expired(req, rid):
                    self.stats.deadline_expired += 1
                    self._finish(rid, resume, "deadline", DeadlineExceeded(
                        f"request {rid}: queued past its "
                        f"{req.deadline_ticks}-tick deadline"))
                else:
                    keep.append((rid, req, resume))
            self._queue = keep
        for i, s in enumerate(self._slots):
            if s is not None and expired(s.request, s.request_id):
                self.stats.deadline_expired += 1
                self._slots[i] = None
                self.engine.free_slot(i)
                self._finish(s.request_id, s.generated, "deadline",
                             DeadlineExceeded(
                                 f"request {s.request_id}: exceeded its "
                                 f"{s.request.deadline_ticks}-tick "
                                 "deadline mid-decode"))

    # -- tenancy: selection, quotas, priority preemption ------------------

    def _quota_need(self, req: Request) -> int:
        """A request's worst-case page reservation: the pages holding
        prompt + ``max_new_tokens`` + the verify step's spec_k
        overshoot, capped at the cache row (the sizing ``page_demand``
        prices at submit); 0 on a dense engine."""
        eng = self.engine
        page_size = getattr(eng, "page_size", None)
        if page_size is None:
            return 0
        total = min(len(req.prompt) + req.max_new_tokens + eng.spec_k,
                    eng.max_len)
        return max_pages_per_slot(total, page_size)

    def _best_queued(self):
        """The best queued candidate under the tenancy policy: ``(key,
        queue index, request)`` with the key ``(chargeable, priority
        desc, vtime asc, tenant id, queue index)``."""
        ten = self.tenancy
        best = None
        for idx, (rid, req, _resume) in enumerate(self._queue):
            chargeable = ten.can_admit(rid, req.tenant_id,
                                       self._quota_need(req))
            k = ten.selection_key(req.tenant_id, chargeable) + (idx,)
            if best is None or k < best[0]:
                best = (k, idx, req)
        return best

    def _promote_next(self) -> bool:
        """Tenancy admission selection: rotate the best queued candidate
        to the queue FRONT (the head-pop admission then runs as it is),
        keeping the others' order (FIFO within a tenant). False when
        every candidate's tenant is quota-blocked: admission defers
        until a completion credits pages back. Untenanted: strict FIFO
        (always True)."""
        if self.tenancy is None:
            return True
        key, best, _ = self._best_queued()
        if key[0] == 1:          # even the best candidate is quota-blocked
            self.stats.quota_deferrals += 1
            return False
        if best:
            items = list(self._queue)
            sel = items.pop(best)
            self._queue.clear()
            self._queue.append(sel)
            self._queue.extend(items)
        return True

    def _charge_head_admission(self, rid: int, req: Request) -> None:
        """Reserve the queue head's quota pages (idempotent: a preempted
        request being re-admitted holds its reservation already) and
        stamp the admitting tenant on the engine. Called only after
        :meth:`_promote_next` returned True, so the charge cannot
        fail."""
        ten = self.tenancy
        if ten is None:
            return
        ten.charge_admission(rid, req.tenant_id, self._quota_need(req))
        self.engine.admission_tenant = req.tenant_id

    def _preempt_for_priority(self) -> None:
        """A strictly-higher-priority waiting tenant may requeue ONE
        resident lower-priority slot a tick, through the requeue-resume
        path pool pressure uses (committed tokens ride along), with no
        retry charged: a capacity decision, not a fault. A free slot, or
        a quota-blocked burst, preempts nobody."""
        ten = self.tenancy
        if ten is None or not self._queue:
            return
        if any(s is None for s in self._slots):
            return
        key, _, best = self._best_queued()
        if key[0] == 1:
            return
        wait_prio = ten.priority(best.tenant_id)
        victim = victim_key = None
        for i, s in enumerate(self._slots):
            rung = ten.priority(s.request.tenant_id)
            if rung >= wait_prio:
                continue            # only STRICTLY lower rungs
            k = (rung, -s.request_id)   # lowest rung, then newest work
            if victim_key is None or k < victim_key:
                victim_key, victim = k, i
        if victim is None:
            return
        s = self._slots[victim]
        self.stats.tenant_preemptions += 1
        if self.tracer.enabled:
            self.tracer.instant(
                "preempted", request_id=s.request_id, slot=victim,
                cause="tenant_priority",
                tenant=self._req_tenant.get(s.request_id, "default"))
        self._queue.appendleft((s.request_id, s.request,
                                list(s.generated)))
        self._slots[victim] = None
        self.engine.free_slot(victim)

    # -- admission --------------------------------------------------------

    def _pool_exhausted(self, rid: int, e: PoolExhausted) -> None:
        """Count a refused admission (the queue then waits in FIFO order
        for evictions), unless the pool cannot serve the head even with
        every slot free and no fault injector to blame: submit-time
        validation should have refused it, and that raises."""
        self.stats.pool_exhausted += 1
        if all(s is None for s in self._slots) \
                and not self.engine.injector.armed:
            err = PoolExhausted(
                "page pool cannot admit the queue head even with every "
                f"slot free (request {rid}) — submit-time validation "
                "should have rejected it", need=e.need, free=e.free,
                cached=e.cached)
            if self.tracer.enabled:
                self.tracer.attach(err)
            raise err from e

    def _first_token(self, logits: torch.Tensor, req: Request, rid: int):
        """The first generated token, from the prefill's (or the final
        chunk's) logits with the key ``fold_in(PRNGKey(seed), 0)``,
        through both gates; ``(token, None)``, or ``(None, error)`` when
        a gate refused it (counted in ``nan_events`` or
        ``bad_samples``)."""
        eng = self.engine
        if not bool(eng.finite(logits).all()):
            self.stats.nan_events += 1
            return None, NonFiniteLogits(
                f"request {rid}: non-finite prefill logits")
        key = prng.fold_in(prng.PRNGKey(req.seed), 0)
        tok = int(eng.sample(logits, key[None], [req.temperature])[0])
        if not 0 <= tok < eng.cfg.vocab_size:
            self.stats.bad_samples += 1
            return None, NonFiniteLogits(
                f"request {rid}: first sampled token {tok} outside "
                f"[0, {eng.cfg.vocab_size})")
        return tok, None

    def _admit(self) -> None:
        if self.tenancy is not None:
            self._preempt_for_priority()
        if self.chunk_tokens is not None:
            self._admit_chunked()
            return
        eng = self.engine
        for i in range(eng.num_slots):
            if self._slots[i] is not None or not self._queue:
                continue
            if not self._promote_next():
                break
            rid, req, resume = self._queue[0]
            self._charge_head_admission(rid, req)
            # a preempted request resumes by re-prefilling everything it
            # had produced EXCEPT its last token, which the next decode
            # tick feeds
            tokens = tuple(req.prompt) + tuple(resume[:-1])
            try:
                logits = eng.prefill(i, tokens)
            except PoolExhausted as e:
                self._pool_exhausted(rid, e)
                break
            except InjectedFault as e:
                # a transient exec failure; the engine rolled back its
                # page references, the request stays at the queue front
                if self._charge_retry(rid):
                    self._queue.popleft()
                    self._finish(rid, resume, "retry_budget",
                                 self._budget_error(rid, e))
                    continue
                break
            self._prefill_ticks[rid] = self._prefill_ticks.get(rid, 0) + 1
            self._charge_work(len(tokens))
            first_tok = None
            if not resume:
                # the first generated token comes from the prefill
                # logits; a resumed request has it already
                first_tok, err = self._first_token(logits, req, rid)
                if err is not None:
                    if self._fail_admission(i, rid, err):
                        continue
                    break
            self._queue.popleft()
            slot = _Slot(rid, req, len(req.prompt), list(resume),
                         len(tokens))
            if self.tracer.enabled:
                self.tracer.instant("admitted", request_id=rid, slot=i,
                                    resumed=bool(resume))
            self._slots[i] = slot
            if first_tok is not None:
                self._append(i, first_tok)
            self._accept_ewma[i] = 1.0
            self._maybe_evict(i)

    def _fail_admission(self, i: int, rid: int, err) -> bool:
        """Roll back a corrupt admission (slot freed, retry charged).
        True when the request terminated (budget gone) and the caller
        moves on; False when it should back off and retry later."""
        self.engine.free_slot(i)
        if self._charge_retry(rid):
            self._queue.popleft()
            # only fresh admissions sample a first token: nothing
            # committed to carry into the outcome
            self._finish(rid, (), "retry_budget",
                         self._budget_error(rid, err))
            return True
        return False

    def _admit_chunked(self) -> None:
        """Chunked admission: claim a free slot and STAGE the prefill
        (pages allocated, no forward run); the chunks run in
        :meth:`_prefill_phase` under the tick token budget."""
        eng = self.engine
        for i in range(eng.num_slots):
            if self._slots[i] is not None or not self._queue:
                continue
            if not self._promote_next():
                break
            rid, req, resume = self._queue[0]
            self._charge_head_admission(rid, req)
            tokens = tuple(req.prompt) + tuple(resume[:-1])
            try:
                state = eng.begin_chunk_prefill(i, tokens)
            except PoolExhausted as e:
                self._pool_exhausted(rid, e)
                break
            self._queue.popleft()
            slot = _Slot(rid, req, len(req.prompt), list(resume),
                         len(tokens))
            slot.prefill = _PrefillProgress(
                tokens=tokens, next=int(state.get("start", 0)), state=state)
            if self.tracer.enabled:
                self.tracer.instant("admitted", request_id=rid, slot=i,
                                    resumed=bool(resume), chunked=True)
            self._slots[i] = slot
            self._accept_ewma[i] = 1.0

    @staticmethod
    def _decoding(s: Optional[_Slot]) -> bool:
        """A slot the decode path may touch: occupied AND past its
        (possibly in-flight chunked) prefill."""
        return s is not None and s.prefill is None

    def _fail_prefill(self, i: int, err) -> None:
        """A chunk faulted or the completed prefill's first token was
        corrupt: free the slot (releasing every staged page), charge the
        retry budget, and requeue at the FRONT with any committed
        progress; the retried prefill restarts from the prompt's
        start."""
        s = self._slots[i]
        self._slots[i] = None
        self.engine.free_slot(i)
        rid = s.request_id
        if self._charge_retry(rid):
            self._finish(rid, s.generated, "retry_budget",
                         self._budget_error(rid, err))
        else:
            self._queue.appendleft((rid, s.request, list(s.generated)))

    def _finish_prefill(self, i: int, logits: torch.Tensor) -> None:
        """The final chunk just ran: register the prefix, then sample the
        first token from the chunk's logits with the monolithic path's
        gates and key, and the slot joins the decode set."""
        s = self._slots[i]
        self.engine.finish_chunk_prefill(i, s.prefill.state)
        s.prefill = None
        if not s.generated:     # a resumed request has its first token
            tok, err = self._first_token(logits, s.request, s.request_id)
            if err is not None:
                self._fail_prefill(i, err)
                return
            self._append(i, tok)
        self._maybe_evict(i)

    def _prefill_phase(self, spent: int) -> None:
        """Run prompt chunks with the token budget the decode phase left
        (at least one chunk a tick, so a full decode batch cannot starve
        admission). The prefilling slots are taken earliest deadline
        first with the request id as the tiebreak (with tenancy: the
        priority rung, then the tenant's vtime, first) and round-robined
        one chunk at a time; each chunk counts ``prefill_chunks``,
        charges the clock its length and, with tenancy, its tenant's
        stride clock. Tenancy also throttles: a tenant whose vtime ran
        more than one chunk stride past the busy floor (the least vtime
        among resident tenants) defers its chunk this tick
        (``chunk_deferrals``); the floor tenant always qualifies."""
        if not any(s is not None and s.prefill is not None
                   for s in self._slots):
            return
        eng = self.engine
        ten = self.tenancy
        budget = max(self.tick_token_budget - spent, 0)
        n_chunks = max(budget // self.chunk_tokens, 1)

        def key(i):
            s = self._slots[i]
            dl = s.request.deadline_ticks
            abs_dl = (self._submit_tick.get(s.request_id, 0) + dl
                      if dl is not None else float("inf"))
            if ten is not None:
                t = s.request.tenant_id
                return (-ten.priority(t), ten.vtime(t), abs_dl,
                        s.request_id)
            return (abs_dl, s.request_id)

        order = deque(sorted(
            (i for i, s in enumerate(self._slots)
             if s is not None and s.prefill is not None), key=key))
        floor = None
        if ten is not None:
            for s in self._slots:
                if s is not None:
                    v = ten.vtime(s.request.tenant_id)
                    if floor is None or v < floor:
                        floor = v
        progressed = set()
        while n_chunks > 0 and order:
            i = order.popleft()
            s = self._slots[i]
            if ten is not None:
                t = s.request.tenant_id
                if ten.vtime(t) > floor + self.chunk_tokens \
                        / ten.tenants[t].weight:
                    # over its share this interval: out of this tick's
                    # rotation only
                    self.stats.chunk_deferrals += 1
                    continue
            p = s.prefill
            n_chunks -= 1
            chunk = p.tokens[p.next:p.next + self.chunk_tokens]
            final = p.next + self.chunk_tokens >= len(p.tokens)
            try:
                logits = eng.chunk_prefill(i, chunk, p.next, p.state,
                                           self.chunk_tokens, final)
            except InjectedFault as e:
                self._fail_prefill(i, e)
                continue
            self.stats.prefill_chunks += 1
            progressed.add(s.request_id)
            self._charge_work(len(chunk))
            if ten is not None:
                ten.charge_tokens(s.request.tenant_id, len(chunk))
            if final:
                self._finish_prefill(i, logits)
            else:
                p.next += self.chunk_tokens
                order.append(i)
        for rid in sorted(progressed):
            self._prefill_ticks[rid] = self._prefill_ticks.get(rid, 0) + 1

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
        self.stats.evictions += 1
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

    def _ngram_or_empty(self, history) -> List[int]:
        """One slot's n-gram draft; a fired ``draft_exec`` site degrades
        it to an empty draft (plain pace, no retry charged)."""
        try:
            return self.engine.draft(history)
        except InjectedFault:
            self.stats.draft_faults += 1
            return []

    def _draft_all(self, ks: List[int]) -> List[List[int]]:
        """One linear draft a slot, up to ``ks[i]`` tokens deep (empty
        for free and depth-0 slots, and for a fired ``draft_exec`` site;
        a model drafter walks its ladder in ``draft_batch``)."""
        eng = self.engine
        hists = self._histories(ks)
        if eng.draft_model is not None:
            try:
                return eng.draft_batch(hists, ks)
            except InjectedFault:
                self.stats.draft_faults += 1
                return [[] for _ in self._slots]
        return [[] if h is None else
                [int(t) for t in self._ngram_or_empty(h)[:ks[i]]]
                for i, h in enumerate(hists)]

    def _draft_trees(self, ks: List[int]):
        """One draft tree a slot (``None`` for free and depth-0 slots and
        fault-degraded ticks): the model drafter's chain plus alternate
        root child, or the n-gram draft as a single chain."""
        eng = self.engine
        hists = self._histories(ks)
        if eng.draft_model is not None:
            try:
                return eng.draft_tree_batch(hists, ks)
            except InjectedFault:
                self.stats.draft_faults += 1
                return [None] * eng.num_slots
        trees = []
        for i, h in enumerate(hists):
            d = [] if h is None else \
                [int(t) for t in self._ngram_or_empty(h)[:ks[i]]]
            trees.append((d, [-1] + list(range(len(d) - 1))) if d else None)
        return trees

    def _key_grid(self, offs) -> torch.Tensor:
        """(B, k1, 2) keys: ``fold_in(PRNGKey(seed), offs[b][j])`` for a
        decoding slot (the plain stream's key for that token),
        ``PRNGKey(0)``'s fold otherwise."""
        rows = []
        for i, s in enumerate(self._slots):
            base = prng.PRNGKey(s.request.seed if self._decoding(s) else 0)
            rows.append(torch.stack([prng.fold_in(base, int(o))
                                     for o in offs[i]]))
        return torch.stack(rows)

    def _temps(self) -> List[float]:
        return [s.request.temperature if self._decoding(s) else 0.0
                for s in self._slots]

    def _prepare(self, positions: Dict[int, int], n_new: int) -> List[int]:
        """Give every decoding slot an exclusive write target for this
        tick (``prepare_decode``), and requeue the slots the pool cannot
        serve at the queue front in submission order (appendleft of the
        newest first leaves the oldest at the front). Returns those
        slots."""
        trc = self.tracer
        if trc.enabled:
            trc.begin("prepare_decode")
        preempted = self.engine.prepare_decode(positions, n_new=n_new)
        if trc.enabled:
            trc.end("prepare_decode", preempted=len(preempted))
        for i in sorted(preempted, key=lambda j: self._slots[j].request_id,
                        reverse=True):
            s = self._slots[i]
            if trc.enabled:
                trc.instant("preempted", request_id=s.request_id, slot=i)
            self._queue.appendleft((s.request_id, s.request,
                                    list(s.generated)))
            self._slots[i] = None
        return preempted

    def _gate(self, i: int, finite: bool, tok: int, what: str):
        """The always-on production gates of a committed position: a
        ``NonFiniteLogits`` (counted in ``nan_events`` or
        ``bad_samples``) when the logits row is not finite or the
        sampled id lies outside the vocabulary, else None."""
        rid = self._slots[i].request_id
        if not finite:
            self.stats.nan_events += 1
            return NonFiniteLogits(f"slot {i} (request {rid}): non-finite "
                                   f"{what} logits")
        vocab = self.engine.cfg.vocab_size
        if not 0 <= tok < vocab:
            self.stats.bad_samples += 1
            return NonFiniteLogits(f"slot {i} (request {rid}): sampled "
                                   f"token {tok} outside [0, {vocab})")
        return None

    def _tick(self) -> None:
        spent = self._decode_phase()
        if self.chunk_tokens is not None:
            self._prefill_phase(spent)

    def _decode_phase(self) -> int:
        """One decode or verify step over every DECODING slot (slots mid
        chunked prefill are invisible here); returns the positions
        computed, which the prefill phase takes from the tick token
        budget."""
        eng = self.engine
        trc = self.tracer
        positions = {i: s.pos for i, s in enumerate(self._slots)
                     if self._decoding(s)}
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
            drafts = None
            if eng.spec_k > 0 and positions:
                if trc.enabled:
                    trc.begin("draft")
                drafts = self._draft_all(self._spec_ks(positions))
                if trc.enabled:
                    trc.end("draft", proposed=sum(len(d) for d in drafts))
            k1 = eng.spec_k + 1
            if drafts is not None and eng.adaptive_spec:
                k1 = 1 + max((len(drafts[i]) for i in positions),
                             default=0)
            spec = bool(drafts is not None and k1 > 1
                        and all(pos + k1 <= eng.max_len
                                for pos in positions.values())
                        and any(drafts[i] for i in positions))
        self._prepare(positions, k1 if spec else 1)
        occupied = [i for i, s in enumerate(self._slots)
                    if self._decoding(s)]
        if not occupied:
            return 0
        if spec:
            self._spec_tick(drafts, k1)
            return k1 * len(occupied)
        self.stats.plain_ticks += 1
        live = [self._decoding(s) for s in self._slots]
        tokens = [s.generated[-1] if d else 0
                  for s, d in zip(self._slots, live)]
        keys = torch.stack([_slot_key(s) if d else prng.PRNGKey(0)
                            for s, d in zip(self._slots, live)])
        logits = eng.decode(tokens, live)
        self.decode_steps += 1
        if trc.enabled:
            trc.begin("accept")
        finite = eng.finite(logits).tolist()
        next_tokens = eng.sample(logits, keys, self._temps()).tolist()
        if trc.enabled:
            trc.end("accept")
            trc.begin("commit")
        quarantined = []
        for i in occupied:
            err = self._gate(i, finite[i], next_tokens[i], "decode")
            if err is not None:
                quarantined.append((i, err))
                continue
            self._slots[i].pos += 1
            self._append(i, next_tokens[i])
            self._maybe_evict(i)
        if trc.enabled:
            trc.end("commit")
        self._quarantine_all(quarantined)
        return len(occupied)

    def _spec_tick(self, drafts: List[List[int]], k1: int) -> None:
        """Draft -> verify -> accept: one verify step over ``k1``
        candidate positions a slot, then a host walk that commits the
        longest prefix of grid samples reproducing the drafts plus the
        first non-matching sample (1..k1 tokens a slot). Position j
        samples with ``fold_in(seed, n_generated + j)``, the plain
        stream's key, so the committed stream is the plain one. The
        gates run on each committed position; a slot that fails one is
        quarantined, keeping the positions committed before it."""
        eng = self.engine
        trc = self.tracer
        self.stats.spec_ticks += 1
        rows = []
        for i, s in enumerate(self._slots):
            d = drafts[i][:k1 - 1]
            rows.append([s.generated[-1] if self._decoding(s) else 0]
                        + d + [0] * (k1 - 1 - len(d)))
        offs = [[(len(s.generated) if self._decoding(s) else 0) + j
                 for j in range(k1)] for s in self._slots]
        keys = self._key_grid(offs)
        logits = eng.verify(rows)
        self.decode_steps += 1
        if trc.enabled:
            trc.begin("accept")
        finite = eng.finite(logits).tolist()                 # (B, k1)
        grid = eng.sample_grid(logits, keys, self._temps()).tolist()
        counts = [0] * eng.num_slots
        quarantined = []
        for i, slot in enumerate(self._slots):
            if not self._decoding(slot):
                continue
            draft = drafts[i]
            committed = accepted = 0
            for j in range(k1):
                # the gates run per committed position only: the grid's
                # tail past the walk conditions on rejected drafts
                tok = grid[i][j]
                err = self._gate(i, finite[i][j], tok, "verify")
                if err is not None:
                    quarantined.append((i, err))
                    break
                slot.pos += 1
                self._append(i, tok)
                committed += 1
                matched = j < len(draft) and draft[j] == tok
                accepted += matched
                if tok == self.eos_id or len(slot.generated) \
                        >= slot.request.max_new_tokens or not matched:
                    break
            counts[i] = committed
            self.stats.tokens_drafted += len(draft)
            self.stats.tokens_accepted += accepted
            if trc.enabled and draft:
                trc.stream_acceptance(i, accepted / len(draft))
            if eng.adaptive_spec and draft:
                self._accept_ewma[i] = 0.5 * self._accept_ewma[i] \
                    + 0.5 * accepted / len(draft)
        if trc.enabled:
            trc.end("accept", committed=sum(counts))
        eng.commit(counts)
        # a tick that commits m tokens counts m on the clock
        if max(counts) > 1:
            self._tick_no += max(counts) - 1
        qset = {i for i, _ in quarantined}
        for i, slot in enumerate(self._slots):
            if slot is not None and i not in qset and counts[i]:
                self._maybe_evict(i)
        # a quarantined slot keeps its committed (plain-stream) tokens:
        # the requeue resumes from them
        self._quarantine_all(quarantined)

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
        trc = self.tracer
        if trc.enabled:
            trc.begin("draft")
        trees = self._draft_trees(self._spec_ks(positions))
        if trc.enabled:
            trc.end("draft", proposed=sum(len(t[0]) for t in trees
                                          if t is not None))
        forced: Dict[int, List[int]] = {}
        for i, s in enumerate(self._slots):
            if self._decoding(s):
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
        for i in self._prepare(positions, k1):
            forced.pop(i, None)
        if not forced:
            return 0
        f_chain: List[List[int]] = []
        g_trees: List[Optional[Tuple[List[int], List[int]]]] = []
        for i, s in enumerate(self._slots):
            if not self._decoding(s):
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
            if self._decoding(s):
                offs[i] = len(s.generated) - len(f_chain[i]) + 1 \
                    + dep_np[i]
        keys = self._key_grid(offs.tolist())
        logits = eng.tree_verify(tok_np, dep_np, anc_np)
        self.decode_steps += 1
        if trc.enabled:
            trc.begin("accept")
        finite = eng.finite(logits)                       # (B, k1)
        grid = eng.sample_grid(logits, keys, self._temps())
        cnts, path = tree_speculative_accept(
            grid.cpu(), torch.from_numpy(tok_np), torch.from_numpy(par_np),
            torch.from_numpy(val_np), torch.from_numpy(start_np))
        cnts, path = cnts.tolist(), path.tolist()
        finite, grid = finite.tolist(), grid.tolist()
        counts = [0] * eng.num_slots          # cache ROWS to commit
        new_tok_max = 0
        quarantined = []
        for i, slot in enumerate(self._slots):
            if not self._decoding(slot):
                continue
            f = len(f_chain[i])
            if f < len(forced[i]):
                # catch-up only: the truncated chain's rows commit,
                # nothing is sampled for this slot this tick
                counts[i] = f
                slot.pos += f
                continue
            nodes = len(g_trees[i][0]) if g_trees[i] is not None else 0
            committed = accepted = g = 0
            bad = None
            for v in range(cnts[i]):
                col = path[i][v]
                # the gates run per VISITED node only: unvisited columns
                # condition on rejected branches
                tok = grid[i][col]
                bad = self._gate(i, finite[i][col], tok, "tree-verify")
                if bad is not None:
                    break
                self._append(i, tok)
                committed += 1
                if v:
                    accepted += 1
                    if g == v - 1 and col == f - 1 + v:
                        g += 1    # the walk stayed on the leftmost chain
                if tok == self.eos_id or len(slot.generated) \
                        >= slot.request.max_new_tokens:
                    break
            # rows: the forced chain plus the contiguous accepted run
            # (the last committed sample has no row yet: it is the next
            # pending token, as in the linear walk)
            counts[i] = f + g
            slot.pos += f + g
            new_tok_max = max(new_tok_max, committed)
            self.stats.tokens_drafted += nodes
            self.stats.tokens_accepted += accepted
            if trc.enabled and nodes:
                trc.stream_acceptance(i, accepted / nodes)
            if eng.adaptive_spec and nodes:
                self._accept_ewma[i] = 0.5 * self._accept_ewma[i] \
                    + 0.5 * accepted / nodes
            if bad is not None:
                quarantined.append((i, bad))
        if trc.enabled:
            trc.end("accept", committed=sum(counts))
        eng.commit(counts)
        self.stats.spec_ticks += 1
        if new_tok_max > 1:
            self._tick_no += new_tok_max - 1
        qset = {i for i, _ in quarantined}
        for i, slot in enumerate(self._slots):
            if slot is not None and i not in qset and counts[i]:
                self._maybe_evict(i)
        self._quarantine_all(quarantined)
        return k1 * len(forced)

    # -- drive loop -------------------------------------------------------

    def _raise_livelock(self, stalled: int) -> None:
        stuck = {"queued": [rid for rid, _, _ in self._queue],
                 "slots": {i: s.request_id
                           for i, s in enumerate(self._slots)
                           if s is not None}}
        err = LivelockError(
            f"no progress (token committed, request terminated, or "
            f"retry consumed) in {stalled} consecutive scheduler "
            f"ticks; stuck requests: queued={stuck['queued']} "
            f"slots={stuck['slots']}; pool={self.engine.pool_snapshot()}",
            stuck=stuck, pool=self.engine.pool_snapshot())
        if self.tracer.enabled:
            self.tracer.attach(err)     # the stuck slots' last events
        raise err

    @property
    def busy(self) -> bool:
        """Work pending: queued requests or occupied slots."""
        return bool(self._queue) or any(s is not None for s in self._slots)

    def step(self) -> None:
        """One scheduler tick: expire deadlines, admit into free slots,
        decode (or verify), and with chunked prefill on run prompt
        chunks with the budget the decode phase left; then flush the
        streams, audit the pool (``audit``) and feed the progress
        watchdog. Public, so an open-loop load generator can interleave
        ``submit`` calls with ticks; :meth:`run` is the drain loop over
        it. A chunk forward counts as progress, with tokens,
        completions and retries."""
        trc = self.tracer
        self._tick_no += 1
        if trc.enabled:
            trc.set_tick(self._tick_no)
        before = self._tokens_emitted
        self._expire_deadlines()
        self._admit()
        self._tick()
        if self.streams is not None:
            # end-of-tick delivery: each stream gets the tokens this tick
            # committed for it, one stream_emit draw a delivering stream
            self.streams.flush()
        if trc.enabled:
            trc.tick_metrics(self._tokens_emitted - before,
                             len(self._queue), self.engine.pool_gauges())
            if self.tenancy is not None:
                trc.tenant_gauges(self.tenancy.gauge_snapshot())
        if self.audit:
            self.engine.check_invariants()
        snap = (self._tokens_emitted, len(self.outcomes),
                self.stats.retries, self.stats.prefill_chunks)
        if snap == self._watch_snap:
            self._stalled += 1
            if self._stalled >= self.watchdog_limit:
                self._raise_livelock(self._stalled)
        else:
            self._stalled, self._watch_snap = 0, snap

    def run(self) -> List[List[int]]:
        """Drain the queue; returns generated tokens (EOS included when
        emitted) per request, in submission order. Typed outcomes —
        degraded ones too, whose tokens are a prefix of the fault-free
        stream — are in ``self.outcomes``. Raises :class:`LivelockError`
        after ``watchdog_limit`` ticks without progress instead of
        spinning."""
        while self.busy:
            self.step()
        return [list(self.outcomes[rid].tokens)
                for rid in sorted(self.outcomes)]

"""Continuous batching over a fixed-slot KV cache (counterpart of
``apex_tpu/serving/scheduler.py``; dense cache, greedy and sampled
requests with the engine's top-k / top-p, plain decode, bf16/fp32 or
weight-only int8 params).

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
of that tick is committed. Faults, tracing, tenancy, streams,
speculative and chunked prefill, and the paged cache are later slices.

The engine's cache is updated in place by each step.
"""

import dataclasses
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from apex_tpu_torch.models.gpt import GPTConfig
from apex_tpu_torch.quant.params import is_quantized_tree
from apex_tpu_torch.serving.cache import init_cache
from apex_tpu_torch.serving.decode import make_decode_fn, make_prefill_fn
from apex_tpu_torch.serving.health import NonFiniteLogits, RequestOutcome
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
        self._queue.append((rid, request))
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
        positions costs that many ticks (a decode step is one)."""
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
            rid, req = self._queue[0]
            tokens = tuple(req.prompt)
            logits = eng.prefill(i, tokens)
            self._prefill_ticks[rid] = self._prefill_ticks.get(rid, 0) + 1
            self._charge_work(len(tokens))
            finite = bool(eng.finite(logits).all())
            key = prng.fold_in(prng.PRNGKey(req.seed), 0)
            first_tok = int(eng.sample(logits, key[None],
                                       [req.temperature])[0])
            self._check(finite, first_tok, f"request {rid}: prefill")
            self._queue.popleft()
            self._slots[i] = _Slot(rid, req, len(req.prompt), [],
                                   len(tokens))
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
        eng.prepare_decode(positions)
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

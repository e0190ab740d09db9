"""Model-based drafting: a small GPT advanced in lockstep with the
target's slots (counterpart of ``apex_tpu/serving/draft_model.py``).

The n-gram drafter (``serving.draft``) is free but proposes nothing on
text that does not repeat. This drafter runs a GPT sharing the target's
vocabulary (``models.gpt.draft_gpt_tiny`` pairs ``gpt_tiny``; the target
may draft for itself) and proposes its greedy continuations.

Lockstep and resync: the drafter keeps its OWN dense KV cache, one row
stream per target slot, and ``_tokens[slot]`` records which tokens' K/V
rows it holds. Each draft call resyncs every slot to the target's
committed history by COMMON PREFIX: rows whose recorded token still
matches are kept, ``lengths`` rolls back to the first divergence, and
the backlog is fed in verify-shaped chunks (``make_verify_fn``). A
rolled-back row is overwritten before any mask admits it, so rejected
drafts, rejected tree branches and skipped ticks need no cleanup. The
last chunk's logits at the final real token are the draft distribution
for the next token: the root of the greedy chain (single-token decode
steps after it) and of the draft tree (the top-2 root children).

Tensor parallelism: pass a ``GPTModel(cfg, tp_size)`` as ``model=``
(and its ``mesh=``, the installed one by default): the drafter then runs
``make_tp_verify_fn`` / ``make_tp_decode_fn`` on this rank's block of
the params (cut once from the whole ``params``) and its head block of
the draft cache, in each rank's process.
"""

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from apex_tpu_torch.models.gpt import GPTConfig
from apex_tpu_torch.quant.params import is_quantized_tree
from apex_tpu_torch.serving.cache import init_cache
from apex_tpu_torch.serving.decode import (
    make_decode_fn, make_tp_decode_fn, make_tp_verify_fn, make_verify_fn,
    shard_tp_cache, shard_tp_params,
)
from apex_tpu_torch.utils.platform import DeviceLike, resolve_device

__all__ = ["DraftModel"]


def _common_prefix(a: Sequence[int], b: Sequence[int]) -> int:
    n = min(len(a), len(b))
    for i in range(n):
        if a[i] != b[i]:
            return i
    return n


class DraftModel:
    """Host-side drafter wrapping a GPT and its lockstep KV cache.

    ``params``/``cfg`` are the draft net (same vocabulary as the
    target; params on ``device``); ``num_slots`` mirrors the target
    engine's; ``max_len`` is the TARGET's max_len — the draft cache adds
    ``chunk`` rows so the last catch-up chunk's pad columns stay in
    bounds. ``model``/``mesh`` switch the forwards to the
    tensor-parallel builders, on this rank's blocks."""

    def __init__(self, params, cfg: GPTConfig, num_slots: int,
                 max_len: int, *, chunk: int = 5, compute_dtype=None,
                 model=None, mesh=None,
                 cache_dtype: torch.dtype = torch.bfloat16,
                 device: DeviceLike = None):
        if chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {chunk}")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = params
        self.num_slots = num_slots
        self.chunk = chunk
        self.cache = init_cache(cfg, num_slots, max_len + chunk,
                                cache_dtype, self.device)
        quantized = is_quantized_tree(params)
        if model is not None:
            if model.cfg is not cfg and model.cfg != cfg:
                raise ValueError("TP draft model config mismatch")
            self.params = shard_tp_params(params, model, quantized, mesh)
            self.cache = shard_tp_cache(self.cache, mesh)
            self._verify = make_tp_verify_fn(model, mesh,
                                             quantized=quantized)
            self._decode = make_tp_decode_fn(model, mesh,
                                             quantized=quantized)
        else:
            self._verify = make_verify_fn(cfg, compute_dtype, quantized)
            self._decode = make_decode_fn(cfg, compute_dtype, quantized)
        # per-slot record of which tokens' K/V rows the cache holds
        self._tokens: List[List[int]] = [[] for _ in range(num_slots)]

    def _tensor(self, x, dtype=torch.int32) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x), dtype=dtype,
                               device=self.device)

    def free_slot(self, slot: int) -> None:
        """Forget a slot (its target slot was freed or preempted): its
        rows become garbage past length 0 and are overwritten on
        reuse."""
        self._tokens[slot] = []
        self.cache.lengths[slot] = 0

    # -- sync ------------------------------------------------------------

    def _sync(self, histories: Sequence[Optional[Sequence[int]]]):
        """Catch every active slot up to its committed history and
        return the root logits (np (B, V)): the draft distribution for
        the token after ``history[-1]``. Inactive slots (None) idle on
        pad feeds at length 0."""
        hists = [list(h) if h else None for h in histories]
        # roll back to the common prefix, held strictly below len(h) so
        # the final chunk always re-feeds history[-1] and yields fresh
        # root logits
        cp = []
        for s in range(self.num_slots):
            h = hists[s]
            if h is None:
                cp.append(0)
                continue
            keep = min(_common_prefix(self._tokens[s], h), len(h) - 1)
            self._tokens[s] = self._tokens[s][:keep]
            cp.append(keep)
        root = np.zeros((self.num_slots, self.cfg.vocab_size), np.float32)
        while True:
            backlog = [len(h) - cp[s] if h is not None else 0
                       for s, h in enumerate(hists)]
            if not any(backlog):
                break
            last_round = max(backlog) <= self.chunk
            grid = np.zeros((self.num_slots, self.chunk), np.int64)
            fed = [0] * self.num_slots
            for s, h in enumerate(hists):
                if h is None:
                    continue
                # hold a slot's final partial chunk for the last round
                # so every active slot's root logits come from one call
                if not last_round and backlog[s] <= self.chunk:
                    continue
                n = min(backlog[s], self.chunk)
                grid[s, :n] = h[cp[s]:cp[s] + n]
                fed[s] = n
            self.cache.lengths.copy_(self._tensor(cp))
            self.cache, logits = self._verify(
                self.params, self.cache, self._tensor(grid, torch.int64))
            if last_round:
                lg = logits.float().cpu().numpy()
                for s in range(self.num_slots):
                    if fed[s]:
                        root[s] = lg[s, fed[s] - 1]
            for s in range(self.num_slots):
                if fed[s]:
                    self._tokens[s].extend(hists[s][cp[s]:cp[s] + fed[s]])
                    cp[s] += fed[s]
            if last_round:
                break
        self.cache.lengths.copy_(self._tensor(cp))
        return root

    def _greedy_steps(self, first: np.ndarray, ks: Sequence[int]):
        """Extend each slot's chain greedily: ``first`` (B,) is the
        chain's first token (chosen from the root logits); returns
        per-slot chains of length ``ks[s]`` (0 -> []). Feeding a chain
        token writes its row and records it — the next sync's common
        prefix decides whether it survives."""
        chains = [[int(first[s])] if ks[s] >= 1 else []
                  for s in range(self.num_slots)]
        steps = max((k - 1 for k in ks), default=0)
        cur = np.array([c[0] if c else 0 for c in chains], np.int64)
        for i in range(steps):
            active = np.array([ks[s] - 1 > i
                               for s in range(self.num_slots)])
            if not active.any():
                break
            self.cache, logits = self._decode(
                self.params, self.cache, self._tensor(cur, torch.int64),
                self._tensor(active, torch.bool))
            nxt = torch.argmax(logits, dim=-1).cpu().numpy()
            for s in range(self.num_slots):
                if active[s]:
                    self._tokens[s].append(int(cur[s]))
                    chains[s].append(int(nxt[s]))
                    cur[s] = nxt[s]
        return chains

    # -- drafting --------------------------------------------------------

    def draft(self, histories: Sequence[Optional[Sequence[int]]],
              ks: Sequence[int]) -> List[List[int]]:
        """Linear drafts: for each active slot, up to ``ks[s]`` greedy
        continuation tokens of ``histories[s]``. The last chain token is
        never fed, so the recorded rows are ``history + chain[:-1]``."""
        root = self._sync(histories)
        ks = [k if histories[s] is not None else 0
              for s, k in enumerate(ks)]
        first = root.argmax(axis=1)
        return self._greedy_steps(first, ks)

    def draft_tree(self, histories: Sequence[Optional[Sequence[int]]],
                   ks: Sequence[int]
                   ) -> List[Optional[Tuple[List[int], List[int]]]]:
        """Tree drafts of up to ``ks[s]`` nodes: a greedy leftmost chain
        of ``k - 1`` tokens plus the SECOND-best root child as an
        alternate branch (both children of the walk root; top-2 of one
        distribution are distinct, as the accept walk needs). Returns
        per-slot ``(tokens, parents)`` with parent ``-1`` = walk root —
        ``None`` for inactive slots or ``k == 0``. Only the leftmost
        chain is fed (and recorded)."""
        root = self._sync(histories)
        ks = [k if histories[s] is not None else 0
              for s, k in enumerate(ks)]
        order = np.argsort(-root, axis=1)
        chains = self._greedy_steps(order[:, 0],
                                    [max(k - 1, min(k, 1)) for k in ks])
        out: List[Optional[Tuple[List[int], List[int]]]] = []
        for s in range(self.num_slots):
            k = ks[s]
            if k <= 0:
                out.append(None)
                continue
            tokens = list(chains[s])
            parents = [-1] + list(range(len(tokens) - 1))
            if k >= 2 and len(tokens) == k - 1:
                tokens.append(int(order[s, 1]))
                parents.append(-1)
            out.append((tokens, parents))
        return out

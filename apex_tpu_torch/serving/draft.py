"""Host-side n-gram / prompt-lookup drafting for self-speculative decode
(counterpart of ``apex_tpu/serving/draft.py``, the same host code).

No draft model: candidate continuations come from the request's OWN
token history (prompt + generated so far) — the prompt-lookup scheme.
The current n-gram suffix of the history is matched against earlier
occurrences; the tokens that followed the most recent earlier match
become the draft. This is a pure function of the token-id sequence:
deterministic, slot-placement-independent, and free (no device work) —
exactly the properties the serving bit-identity contract needs, since
a WRONG draft only costs verify throughput, never correctness (the
verify + accept path resamples with the plain decode stream's keys).

The drafter may return fewer than ``k`` tokens (including zero, when
the suffix never recurred); the scheduler pads the verify bucket and
bounds acceptance by the true draft length.

``tree_arrays`` is the grid packer shared by the tree-speculation
paths (scheduler, bench, tests): it lowers per-slot draft trees —
``(tokens, parents)`` lists, parent ``-1`` = child of the walk root —
plus each slot's FORCED token chain (committed tokens whose cache rows
must be re-sent; at least the pending token) into the padded
``(tokens, depth, anc, valid, start)`` arrays
``decode.make_tree_verify_fn`` and ``sampling.tree_speculative_accept``
consume.
"""

from typing import List, Sequence, Tuple

import numpy as np

__all__ = ["ngram_draft", "tree_arrays"]


def tree_arrays(forced: Sequence[Sequence[int]],
                trees: Sequence[Tuple[Sequence[int], Sequence[int]]],
                k1: int):
    """Pack B slots' forced chains + draft trees into one verify grid.

    ``forced[b]`` (length f_b >= 1, f_b + len(tree tokens) <= k1) are
    tokens re-sent as a linear chain occupying grid columns 0..f_b-1
    (the last one is the walk root / pending token); ``trees[b]`` is
    ``(tokens, parents)`` in topological order (``parents[i] < i``;
    ``-1`` roots attach to the walk root). Returns numpy arrays:
    tokens (B, k1) int32 (0-padded), depth (B, k1) int32 (pad columns
    0 — their rows are garbage by the write-then-attend contract),
    anc (B, k1, k1) bool (anc[i, j]: column i visible to query column
    j; pads see only themselves), valid (B, k1) bool (True on draft
    -node columns — the accept walk's candidate set), parents (B, k1)
    int32 (each column's parent GRID column; -1 on pads and the first
    forced column, which never match a walk position), start (B,)
    int32 (= f_b - 1, the walk root column)."""
    b = len(forced)
    tokens = np.zeros((b, k1), np.int32)
    depth = np.zeros((b, k1), np.int32)
    anc = np.zeros((b, k1, k1), bool)
    valid = np.zeros((b, k1), bool)
    parents = np.full((b, k1), -1, np.int32)
    start = np.zeros((b,), np.int32)
    np.einsum("bii->bi", anc)[:] = True          # self-visibility, pads too
    for i in range(b):
        chain = list(forced[i])
        t_toks, t_par = trees[i] if trees[i] is not None else ([], [])
        f = len(chain)
        if f < 1:
            raise ValueError("forced chain needs at least the pending "
                             "token")
        if f + len(t_toks) > k1:
            raise ValueError(f"forced ({f}) + tree ({len(t_toks)}) "
                             f"exceeds grid width {k1}")
        tokens[i, :f] = chain
        depth[i, :f] = np.arange(f)
        for j in range(f):
            anc[i, : j + 1, j] = True
            if j:
                parents[i, j] = j - 1
        start[i] = f - 1
        for n, (tok, par) in enumerate(zip(t_toks, t_par)):
            col = f + n
            if not (-1 <= par < n):
                raise ValueError(f"parent {par} of tree node {n} is not "
                                 f"an earlier node")
            pcol = f - 1 if par == -1 else f + par
            tokens[i, col] = tok
            depth[i, col] = depth[i, pcol] + 1
            anc[i, :, col] = anc[i, :, pcol]
            anc[i, col, col] = True
            valid[i, col] = True
            parents[i, col] = pcol
    return tokens, depth, anc, valid, parents, start


def ngram_draft(history: Sequence[int], k: int, *, max_ngram: int = 3,
                min_ngram: int = 1) -> List[int]:
    """Propose up to ``k`` draft tokens from ``history``.

    Tries suffix n-grams longest-first (``max_ngram`` down to
    ``min_ngram``): for each n, find the MOST RECENT earlier occurrence
    of ``history[-n:]`` that has at least one continuation token
    (the terminal self-match is excluded), and return the up-to-``k``
    tokens that followed it. Longer suffixes are stronger evidence, so
    the first hit wins; recency breaks ties within a length (repeated
    phrases drift, and the latest occurrence tracks the current one
    best). Returns ``[]`` when ``k <= 0``, the history is shorter than
    ``min_ngram + 1``, or no suffix recurs.
    """
    if k <= 0 or min_ngram < 1 or max_ngram < min_ngram:
        return []
    hist = list(history)
    n_hist = len(hist)
    for n in range(min(max_ngram, n_hist - 1), min_ngram - 1, -1):
        suffix = hist[n_hist - n:]
        # latest start i with a continuation: i + n <= n_hist - 1, and
        # i < n_hist - n excludes the suffix matching itself
        for i in range(n_hist - n - 1, -1, -1):
            if hist[i:i + n] == suffix:
                return hist[i + n:i + n + k]
    return []

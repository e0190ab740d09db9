"""Token sampling under explicit PRNG keys (counterpart of
``apex_tpu/serving/sampling.py``).

Every sampled row draws with its own ``utils.prng`` key — the scheduler
derives them as ``fold_in(PRNGKey(request.seed), n_generated)`` — so a
replayed request stream regenerates the same tokens, and they are the
JAX scheduler's: the threefry bits are jax's bit for bit, and only the
gumbel transform's ``log`` rounds otherwise (``prng.gumbel_limit``), so
a token can differ only where a row's two best perturbed scores lie
within twice that limit. ``top_k`` / ``top_p`` are engine settings;
greedy rows (``temperature <= 0``) take the argmax of the raw logits.

The nucleus boundary (``top_p``): the kept set is the smallest prefix of
the sorted probabilities whose mass before the token is below
``top_p``. The softmax and its running sum round otherwise than XLA's
(``jnp.cumsum`` is an fp32 sum in XLA's order), so a token whose
preceding mass lies within about ``V * 2^-23`` of ``top_p`` may fall on
the other side.

Speculative decoding samples a verify step's (B, k1, V) grid with the
plain stream's key at every position (:func:`sample_token_grid`), so
its accept rules (:func:`speculative_accept`,
:func:`tree_speculative_accept`) only compare tokens: the committed
stream is the plain one, and acceptance changes the step count only.
"""

import torch

from apex_tpu_torch.utils import prng


def _restrict(logits: torch.Tensor, top_k: int,
              top_p: float) -> torch.Tensor:
    """Mask ``logits`` (..., V) to the top-k / nucleus support with
    ``-inf`` (on the RAW logits, before temperature, so the support does
    not depend on it)."""
    if top_k:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits >= kth, logits, -torch.inf)
    if top_p and top_p < 1.0:
        srt = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(srt, dim=-1)
        # keep a sorted token while the mass BEFORE it is < top_p (the
        # argmax always survives: its "before" mass is 0)
        keep = torch.cumsum(probs, dim=-1) - probs < top_p
        thresh = torch.where(keep, srt, torch.inf).amin(dim=-1,
                                                        keepdim=True)
        logits = torch.where(logits >= thresh, logits, -torch.inf)
    return logits


def sample_tokens(logits: torch.Tensor, keys, temperature: torch.Tensor,
                  top_k: int = 0, top_p: float = 0.0) -> torch.Tensor:
    """logits (B, V) fp32; keys (B, 2) (stacked ``utils.prng`` keys);
    temperature (B,) — ``t <= 0`` means greedy for that slot. ``top_k``
    (0 = full vocab) restricts sampling to each row's k largest logits,
    ``top_p`` (0 or 1 = off) to the smallest set whose softmax mass
    reaches p. Returns (B,) int32 token ids (the first maximum on ties,
    as ``jnp.argmax``)."""
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    logits = _restrict(logits, top_k, top_p)
    scaled = logits / torch.clamp(temperature, min=1e-6)[:, None]
    sampled = prng.categorical_rows(keys, scaled).to(torch.int32)
    return torch.where(temperature > 0, sampled, greedy)


def sample_token_grid(logits: torch.Tensor, keys, temperature: torch.Tensor,
                      top_k: int = 0, top_p: float = 0.0) -> torch.Tensor:
    """:func:`sample_tokens` over a verify step's (B, k1, V) logits with
    per-position keys (B, k1, 2): position (b, j) draws with
    ``keys[b, j]`` and slot b's temperature. Returns (B, k1) int32."""
    b, k1, v = logits.shape
    toks = sample_tokens(logits.reshape(b * k1, v),
                         torch.as_tensor(keys).reshape(b * k1, 2),
                         temperature.repeat_interleave(k1), top_k, top_p)
    return toks.reshape(b, k1)


def speculative_accept(tokens: torch.Tensor, drafts: torch.Tensor,
                       draft_lens: torch.Tensor) -> torch.Tensor:
    """The linear accept rule: ``tokens`` (B, k1) the grid-sampled
    tokens, ``drafts`` (B, k) the 0-padded drafts, ``draft_lens`` (B,)
    their true lengths. Draft j is accepted iff every draft before it
    matched its sample and ``tokens[:, j] == drafts[:, j]`` with ``j <
    draft_len``. Returns (B,) int32 accepted counts in [0, k]; the
    commit is ``tokens[:, :accepted + 1]``. The sampled grid already IS
    the plain stream (each position drew with the plain stream's key),
    so acceptance is "did the plain stream reproduce the draft"."""
    k = drafts.shape[1]
    idx = torch.arange(k, device=drafts.device)
    match = (tokens[:, :k] == drafts) & (idx[None, :]
                                         < draft_lens[:, None])
    return torch.cumprod(match.to(torch.int32), dim=1).sum(dim=1).to(
        torch.int32)


def tree_speculative_accept(samples: torch.Tensor, tokens: torch.Tensor,
                            parents: torch.Tensor, valid: torch.Tensor,
                            start=None):
    """:func:`speculative_accept` over a draft TREE: from ``cur =
    start`` (the walk root, the last forced column; 0 without it) commit
    ``samples[cur]`` and descend to the valid child whose INPUT token
    equals it (children of one node carry distinct tokens), until no
    child matches. ``samples``, ``tokens`` (B, k1), ``parents`` (B, k1)
    each node's parent column, ``valid`` (B, k1) bool the draft-node
    columns. Returns (counts (B,) int32 in [1, k1], path (B, k1) int32
    visited columns, -1 past the path)."""
    b, k1 = samples.shape
    dev = samples.device
    cur = torch.zeros((b,), dtype=torch.long, device=dev) \
        if start is None else torch.as_tensor(start, device=dev).long()
    alive = torch.ones((b,), dtype=torch.bool, device=dev)
    idx = torch.arange(k1, device=dev)[None, :]
    path = []
    for _ in range(k1):
        s = samples.gather(1, cur[:, None])[:, 0]
        cand = valid & (parents == cur[:, None]) & \
            (tokens == s[:, None]) & (idx > cur[:, None])
        nxt = torch.argmax(cand.to(torch.int32), dim=1)
        path.append(torch.where(alive, cur, torch.full_like(cur, -1)))
        alive = alive & cand.any(dim=1)
        cur = torch.where(alive, nxt, cur)
    path = torch.stack(path, dim=1).to(torch.int32)
    return (path >= 0).sum(dim=1).to(torch.int32), path


def finite_rows(logits: torch.Tensor) -> torch.Tensor:
    """(..., V) -> (...,) bool: True where a row is entirely finite —
    the gate that keeps a NaN/Inf row from ever being sampled."""
    return torch.isfinite(logits).all(dim=-1)

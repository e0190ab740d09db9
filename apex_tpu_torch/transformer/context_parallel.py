"""Context parallelism: ring and Ulysses attention over the ``context``
axis (counterpart of ``apex_tpu/transformer/context_parallel.py``).

Both take q, k, v (b, h, s_local, d): this rank's block of the sequence,
the ``context`` axis's ranks holding the blocks in order.

- :func:`ring_attention` keeps the queries and passes the k/v blocks
  round the ring (k and v stacked, each step one shift +1 along the
  ``context`` group, ``tensor_parallel.mappings.shift``, whose backward
  is the reverse shift), folding each block into the JAX package's fp32
  online-softmax recurrence: additive -1e30 masking, the causal mask
  from global positions (the rank's index on the axis), fully masked
  rows 0. The
  block is plain PyTorch, as it is plain ``jnp`` in the JAX package (no
  Pallas kernel); ``checkpoint_blocks`` recomputes each block in the
  backward (``torch.utils.checkpoint``), keeping one block's scores
  live. No rank holds the whole sequence or an (s, s) score tile.
- :func:`ulysses_attention` swaps the sharded dimension with two tiled
  all-to-alls (``mappings.all_to_all``; q, k and v stacked into one):
  each rank attends over the whole sequence for ``h/cp`` heads through
  ``flash_attention`` (the hand kernel on a CUDA tensor), then the
  output goes back. The key mask is all-gathered.
"""

import math
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from apex_tpu_torch.transformer import parallel_state as ps
from apex_tpu_torch.transformer.tensor_parallel.mappings import (
    all_to_all, collective, shift,
)

_NEG = -1e30


def _block(m_run, l_run, acc, q32, k_blk, v_blk, valid, softmax_scale):
    """One online-softmax update of the running (max, sum, output)
    against one k/v block; ``valid`` (broadcastable to the scores) or
    None for all keys."""
    s = torch.matmul(q32, k_blk.float().transpose(-1, -2)) * softmax_scale
    if valid is not None:
        s = torch.where(valid, s, torch.full((), _NEG, device=s.device))
    m_cur = torch.maximum(m_run, s.amax(-1, keepdim=True))
    alpha = torch.exp(m_run - m_cur)
    p = torch.exp(s - m_cur)
    if valid is not None:
        p = torch.where(valid, p, torch.zeros((), device=p.device))
    l_run = l_run * alpha + p.sum(-1, keepdim=True)
    acc = acc * alpha + torch.matmul(p, v_blk.float())
    return m_cur, l_run, acc


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mask: Optional[torch.Tensor] = None, *,
                   causal: bool = False,
                   softmax_scale: Optional[float] = None,
                   axis_name: str = ps.CONTEXT_AXIS,
                   checkpoint_blocks: bool = True) -> torch.Tensor:
    """Exact attention over a context-sharded sequence.

    Args:
      q, k, v: (b, h, s_local, d), this rank's sequence block.
      mask: optional (b, s_local) key-padding mask (1 = attend).
      causal: the upper triangle masked at global positions.
      axis_name: the mesh axis the sequence is split over.

    Returns (b, h, s_local, d) in q's dtype, this rank's output block.
    """
    if softmax_scale is None:
        softmax_scale = 1.0 / math.sqrt(q.shape[-1])
    cp = ps.get_mesh().shape[axis_name]
    rank = ps.get_mesh()._coords()[ps.MESH_AXIS_NAMES.index(axis_name)]
    b, h, s_loc, d = q.shape
    dev = q.device
    q32 = q.float()
    q_pos = rank * s_loc + torch.arange(s_loc, device=dev)
    blk = _block
    if checkpoint_blocks and torch.is_grad_enabled():
        def blk(*a):
            return checkpoint(_block, *a, use_reentrant=False)

    # the mask rides the ring only when one exists (causal needs none)
    km = None if mask is None else mask.to(torch.int32)
    m_run = torch.full((b, h, s_loc, 1), _NEG, device=dev)
    l_run = torch.zeros((b, h, s_loc, 1), device=dev)
    acc = torch.zeros((b, h, s_loc, d), device=dev)
    # k and v ride the ring as one stacked tensor: one exchange a step,
    # so every rank's backward posts its reverse shifts in one order
    kv = torch.stack([k, v])
    for j in range(cp):
        src = (rank - j) % cp           # whose block this is
        valid = None
        if km is not None:
            valid = (km != 0)[:, None, None, :]
        if causal:
            k_pos = src * s_loc + torch.arange(s_loc, device=dev)
            tri = (k_pos[None, :] <= q_pos[:, None])[None, None]
            valid = tri if valid is None else (valid & tri)
        m_run, l_run, acc = blk(m_run, l_run, acc, q32, kv[0], kv[1], valid,
                                softmax_scale)
        # cp - 1 rotations: rotating after the last block would send a
        # whole k/v round only to drop it
        if j < cp - 1:
            kv = shift(kv, axis_name, 1)
            if km is not None:
                km = shift(km, axis_name, 1)
    pos = l_run > 0
    out = torch.where(pos, acc / torch.where(pos, l_run,
                                              torch.ones((), device=dev)),
                      torch.zeros((), device=dev))
    return out.to(q.dtype)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      mask: Optional[torch.Tensor] = None, *,
                      causal: bool = False,
                      softmax_scale: Optional[float] = None,
                      axis_name: str = ps.CONTEXT_AXIS,
                      attention_fn=None) -> torch.Tensor:
    """Ulysses sequence parallelism (DeepSpeed-Ulysses): two tiled
    all-to-alls swap the split dimension so each rank attends over the
    whole sequence for ``h/cp`` heads, then swap back (q, k and v ride
    one stacked all-to-all in, the output one back).

    Args:
      q, k, v: (b, h, s_local, d), this rank's sequence block.
      mask: optional (b, s_local) key-validity block (1 = attend),
        all-gathered to the whole sequence.
      attention_fn: the whole-sequence attention a head group runs;
        ``functional.flash_attention`` by default (the hand kernel on a
        CUDA tensor).

    Returns (b, h, s_local, d) in q's dtype.
    """
    cp = ps.get_mesh().shape[axis_name]
    b, h, s_loc, d = q.shape
    if h % cp:
        raise ValueError(
            f"ulysses_attention needs heads % cp == 0, got {h} % {cp}")
    if attention_fn is None:
        from apex_tpu_torch.transformer.functional.flash_attention import (
            flash_attention,
        )
        attention_fn = flash_attention

    # ONE stacked all-to-all for q/k/v: (3, b, h, s/cp, d), the heads
    # scattering over the ranks while the sequence gathers
    qkv = all_to_all(torch.stack([q, k, v]), axis_name, 2, 3)
    full_mask = mask
    if mask is not None and cp > 1:
        mesh = ps.get_mesh()
        full_mask = collective("all_gather", mask, mesh.groups[axis_name],
                               mesh.members(axis_name), dim=1)
    out = attention_fn(qkv[0], qkv[1], qkv[2], full_mask, causal=causal,
                       softmax_scale=softmax_scale)
    # the inverse swap: the heads gather back, the sequence re-splits
    return all_to_all(out, axis_name, 2, 1).to(q.dtype)

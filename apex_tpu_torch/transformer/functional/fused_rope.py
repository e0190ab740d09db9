"""Rotary positional embedding (RoPE): the counterpart of
``apex_tpu/transformer/functional/fused_rope.py``.

The JAX package computes RoPE with XLA ops (no Pallas kernel) and a
``custom_vjp``; this module is its plain PyTorch port, with the
``custom_vjp`` as a ``torch.autograd.Function``:

- forward: ``t * cos + rotate_half(t) * sin`` in fp32 on the leading
  ``d_rot = cos.shape[-1]`` channels, cast back to t's dtype once; the
  trailing ``d - d_rot`` channels pass through;
- backward: ``dt`` is the same form with ``-sin`` (the transpose of a
  rotation is the rotation by the negated angle), and ``dcos`` / ``dsin``
  are the product rule's factors ``g * t`` and ``g * rotate_half(t)``,
  summed over the axes the tables broadcast: true cotangents, so a
  learned or scaled rotary table trains. They are computed only where
  autograd asks for them (a table built from positions needs none).

Conventions (the reference's): ``freqs`` holds the angles (position
times inverse frequency), not yet cos/sin, shaped (s, 1, 1, d_rot);
tensors are sbhd unless the ``_bshd`` / ``_bhsd`` wrappers are used.

Error model against the JAX functions (the tests hold the port to it).
The angles are computed in the same fp32 operations and agree bit for
bit; torch's ``cos`` and ``sin`` may land one fp32 ulp from XLA's. So an
fp32 output may differ by a few fp32 ulps of ``|t| (|cos| + |sin|)``
(the two products, their sum, and the tables' ulp), and a bf16 output
by one bf16 ulp of the output (the fp32 results straddle a rounding
boundary). The backward's ``dt`` follows the same model on ``g``;
``dcos`` and ``dsin`` add the sum over the broadcast axes, whose order
differs: ``2 n`` ulps of ``sum |g t|`` over the ``n`` terms summed.
"""

from typing import Optional, Tuple

import torch

from apex_tpu_torch.utils.platform import DeviceLike, resolve_device


def rope_frequencies(dim: int, seq_len: int, base: float = 10000.0,
                     dtype: torch.dtype = torch.float32,
                     device: DeviceLike = None) -> torch.Tensor:
    """The (s, 1, 1, dim) angle tensor θ_{p,i} = p · base^(-2i/dim):
    inverse frequencies over the even channels, angles duplicated
    across the two rotation halves (the JAX function's fp32 operations,
    in its order)."""
    dev = resolve_device(device)
    inv_freq = 1.0 / (base ** (torch.arange(
        0, dim, 2, dtype=torch.float32, device=dev) / dim))
    pos = torch.arange(seq_len, dtype=torch.float32, device=dev)
    ang = torch.outer(pos, inv_freq)                   # (s, dim/2)
    ang = torch.cat([ang, ang], dim=-1)                # (s, dim)
    return ang.to(dtype)[:, None, None, :]


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def _apply(t: torch.Tensor, cos: torch.Tensor,
           sin: torch.Tensor) -> torch.Tensor:
    """t*cos + rotate_half(t)*sin on the leading d_rot channels, fp32
    inside, cast back to t's dtype once."""
    d_rot = cos.shape[-1]
    rot, rest = (t[..., :d_rot], t[..., d_rot:]) if d_rot < t.shape[-1] \
        else (t, None)
    r32 = rot.float()
    out = (r32 * cos.float() + _rotate_half(r32) * sin.float()).to(t.dtype)
    if rest is not None:
        out = torch.cat([out, rest], dim=-1)
    return out


def _reduce_to(x: torch.Tensor, shape) -> torch.Tensor:
    """Sum ``x`` over the axes the (same-rank) target ``shape``
    broadcasts."""
    axes = tuple(i for i, n in enumerate(shape) if n == 1 and x.shape[i] != 1)
    return x.sum(dim=axes, keepdim=True) if axes else x


class _RopeCore(torch.autograd.Function):
    """The JAX package's ``_rope_core`` ``custom_vjp``."""

    @staticmethod
    def forward(ctx, t, cos, sin):
        ctx.save_for_backward(t, cos, sin)
        return _apply(t, cos, sin)

    @staticmethod
    def backward(ctx, g):
        t, cos, sin = ctx.saved_tensors
        d_rot = cos.shape[-1]
        dt = _apply(g, cos, -sin) if ctx.needs_input_grad[0] else None
        dcos = dsin = None
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            g32 = g[..., :d_rot].float()
            r32 = t[..., :d_rot].float()
            dcos = _reduce_to(g32 * r32, cos.shape).to(cos.dtype)
            dsin = _reduce_to(g32 * _rotate_half(r32), sin.shape).to(
                sin.dtype)
        return dt, dcos, dsin


def _rope_core(t: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    return _RopeCore.apply(t, cos, sin)


def fused_apply_rotary_pos_emb(t: torch.Tensor,
                               freqs: torch.Tensor) -> torch.Tensor:
    """t (s, b, h, d), freqs (s, 1, 1, d_rot) angles; returns t's dtype
    and shape."""
    return _rope_core(t, torch.cos(freqs), torch.sin(freqs))


def fused_apply_rotary_pos_emb_cached(t: torch.Tensor, cos: torch.Tensor,
                                      sin: torch.Tensor) -> torch.Tensor:
    """Precomputed cos/sin (s, 1, 1, d_rot): saves the transcendentals
    when the tables are reused across layers."""
    return _rope_core(t, cos, sin)


def fused_apply_rotary_pos_emb_bshd(t: torch.Tensor,
                                    freqs: torch.Tensor) -> torch.Tensor:
    """(b, s, h, d) layout wrapper."""
    cos, sin = torch.cos(freqs), torch.sin(freqs)
    return _rope_core(t, cos[None, :, 0], sin[None, :, 0])


def fused_apply_rotary_pos_emb_bhsd(t: torch.Tensor, freqs: torch.Tensor,
                                    positions: Optional[torch.Tensor] = None
                                    ) -> torch.Tensor:
    """(b, h, s, d) layout wrapper, the models' attention layout.

    ``positions`` selects absolute angles from the ``freqs`` table. A
    (b,) integer tensor rotates row ``i`` of ``t`` as if its ``s``
    positions were ``positions[i], positions[i] + 1, ...`` (incremental
    decode: a one-token query at cache offset ``p`` is rotated by θ_p);
    a (b, s) one gives every element its own position (tree verify).
    Positions past the table read its last row, as JAX's gather clamps,
    and pass no gradient to the table, as its transpose drops them.
    ``None`` takes rows ``0..s-1`` for every batch row (training and
    prefill)."""
    cos = torch.cos(freqs).reshape(freqs.shape[0], freqs.shape[-1])
    sin = torch.sin(freqs).reshape(freqs.shape[0], freqs.shape[-1])
    if positions is None:
        return _rope_core(t, cos[None, None], sin[None, None])
    # (b, s) absolute positions -> gathered (b, 1, s, d_rot) factors
    # broadcasting over the head axis of t (b, h, s, d)
    if positions.dim() == 2:
        idx = positions.long()
    else:
        idx = positions.long()[:, None] + torch.arange(
            t.shape[2], device=positions.device)[None, :]
    inside = idx.clamp(0, cos.shape[0] - 1)
    cos, sin = cos[inside], sin[inside]
    if freqs.requires_grad:
        kept = (inside == idx)[..., None]
        cos = torch.where(kept, cos, cos.detach())
        sin = torch.where(kept, sin, sin.detach())
    return _rope_core(t, cos[:, None], sin[:, None])


def rope_cos_sin(dim: int, seq_len: int, base: float = 10000.0,
                 dtype: torch.dtype = torch.float32,
                 device: DeviceLike = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Precomputed (cos, sin) tables for the ``_cached`` entry point."""
    freqs = rope_frequencies(dim, seq_len, base, torch.float32, device)
    return torch.cos(freqs).to(dtype), torch.sin(freqs).to(dtype)

"""Minimal functional layers (counterpart of
``apex_tpu/models/layers.py``), the part BERT and ResNet need: params are
dicts of tensors, ``init_*(generator, ...) -> params`` plus an apply
function. Compute follows the caller's AMP policy (params cast outside).
The JAX ``dense`` and ``conv`` also pass through the O1 ``cast_args`` op
policy; O1 is not ported, so here they are the plain products.

Layouts are the JAX package's: activations NHWC, conv kernels HWIO, so a
tree carried across from JAX (and its flat optimizer layout) lines up
leaf for leaf. ``conv`` permutes at the call: an NHWC tensor permuted to
NCHW is already a ``channels_last`` tensor, which cuDNN takes without a
copy.

Random draws come from a ``torch.Generator`` on its own device and are
then moved to ``device``; they cannot reproduce JAX's threefry draws,
so parity tests carry JAX-initialised trees across instead
(``models._convert.params_from_jax``).
"""

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from apex_tpu_torch.utils.platform import DeviceLike, resolve_device


def lecun_normal(generator: torch.Generator, shape: Sequence[int],
                 fan_in: int, dtype: torch.dtype = torch.float32,
                 device: DeviceLike = None) -> torch.Tensor:
    x = torch.randn(tuple(shape), generator=generator, dtype=dtype,
                    device=generator.device) * math.sqrt(1.0 / fan_in)
    return x.to(resolve_device(device))


def kaiming_normal(generator: torch.Generator, shape: Sequence[int],
                   fan_in: int, dtype: torch.dtype = torch.float32,
                   device: DeviceLike = None) -> torch.Tensor:
    x = torch.randn(tuple(shape), generator=generator, dtype=dtype,
                    device=generator.device) * math.sqrt(2.0 / fan_in)
    return x.to(resolve_device(device))


def trunc_normal(generator: torch.Generator, shape: Sequence[int],
                 stddev: float = 0.02, dtype: torch.dtype = torch.float32,
                 device: DeviceLike = None) -> torch.Tensor:
    """N(0, 1) truncated to [-2, 2], times ``stddev``."""
    x = torch.empty(tuple(shape), dtype=dtype, device=generator.device)
    torch.nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return (x * stddev).to(resolve_device(device))


# -- dense ------------------------------------------------------------------

def init_dense(generator: torch.Generator, in_features: int,
               out_features: int, *, bias: bool = True, init=trunc_normal,
               dtype: torch.dtype = torch.float32,
               device: DeviceLike = None) -> dict:
    """kernel (in, out) from ``init`` (:func:`trunc_normal`, stddev 0.02,
    or a fan-in initializer such as :func:`lecun_normal`), zero bias."""
    shape = (in_features, out_features)
    p = {"kernel": trunc_normal(generator, shape, dtype=dtype, device=device)
         if init is trunc_normal else
         init(generator, shape, in_features, dtype=dtype, device=device)}
    if bias:
        p["bias"] = torch.zeros((out_features,), dtype=dtype,
                                device=resolve_device(device))
    return p


def dense(params: dict, x: torch.Tensor) -> torch.Tensor:
    return (torch.matmul(x, params["kernel"].to(x.dtype))
            + params["bias"].to(x.dtype))


# -- conv (NHWC) ------------------------------------------------------------

def init_conv(generator: torch.Generator, in_ch: int, out_ch: int,
              kernel: Tuple[int, int], dtype: torch.dtype = torch.float32,
              device: DeviceLike = None) -> dict:
    """An HWIO kernel from :func:`kaiming_normal`, no bias."""
    fan_in = in_ch * kernel[0] * kernel[1]
    return {"kernel": kaiming_normal(generator, tuple(kernel) + (in_ch,
                                                                 out_ch),
                                     fan_in, dtype, device)}


def same_pads(size: int, k: int, stride: int) -> Tuple[int, int]:
    """XLA's ``padding="SAME"``: (lo, hi) = (total // 2, total - total //
    2), so a stride-2 window pads more at the end (the 7x7 stem on 224
    pads (2, 3), a 3x3 on 56 pads (0, 1))."""
    total = max((-(-size // stride) - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv(params: dict, x: torch.Tensor, stride: int = 1,
         padding="SAME") -> torch.Tensor:
    """NHWC ``x`` through an HWIO kernel (cast to x's dtype).
    ``padding`` as ``lax.conv_general_dilated`` takes it: "SAME"
    (uneven where the stride needs it, the only padding the JAX ResNet
    uses), "VALID", or ((top, bottom), (left, right))."""
    k = params["kernel"].to(x.dtype)
    if padding == "SAME":
        (ht, hb), (wl, wr) = (same_pads(x.shape[1], k.shape[0], stride),
                              same_pads(x.shape[2], k.shape[1], stride))
    elif padding == "VALID":
        ht = hb = wl = wr = 0
    else:
        (ht, hb), (wl, wr) = padding
    xn = x.permute(0, 3, 1, 2)           # NCHW view, channels_last memory
    pad = (ht, wl)
    if (ht, wl) != (hb, wr):
        xn, pad = F.pad(xn, (wl, wr, ht, hb)), (0, 0)
    y = F.conv2d(xn, k.permute(3, 2, 0, 1), stride=stride, padding=pad)
    return y.permute(0, 2, 3, 1)


# -- batch norm -------------------------------------------------------------

def init_batchnorm(ch: int, device: DeviceLike = None) -> Tuple[dict, dict]:
    """Returns (params, running_state), all fp32: scale 1, bias 0, mean
    0, var 1."""
    dev = resolve_device(device)

    def full(v):
        return torch.full((ch,), v, dtype=torch.float32, device=dev)

    return ({"scale": full(1.0), "bias": full(0.0)},
            {"mean": full(0.0), "var": full(1.0)})


class _GroupMean(torch.autograd.Function):
    """``lax.pmean`` over a process group: the all-reduced sum divided by
    the group's size; its backward is pmean's transpose, the cotangent
    divided by the size and all-reduced (``dist.all_reduce`` itself
    carries no gradient)."""

    @staticmethod
    def forward(ctx, x, group, size):
        ctx.group, ctx.size = group, size
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y / size

    @staticmethod
    def backward(ctx, g):
        g = g / ctx.size
        dist.all_reduce(g, group=ctx.group)
        return g, None, None


def batchnorm(params: Optional[dict], state: Optional[dict],
              x: torch.Tensor, *, train: bool, momentum: float = 0.9,
              eps: float = 1e-5, axis_name=None, axis_index_groups=None
              ) -> Tuple[torch.Tensor, Optional[dict]]:
    """BatchNorm over all but the channel (last) axis, as the JAX package
    computes it (not ``F.batch_norm``'s conventions): in fp32, var =
    E[x^2] - E[x]^2; ``momentum`` is the KEEP fraction (new = momentum
    old + (1 - momentum) batch); the running variance takes the unbiased
    n / (n - 1); the output is cast back to x's dtype. ``params=None``
    skips the affine transform; ``state=None`` tracks no running stats
    (batch statistics even when not training). The new running stats
    carry no gradient.

    ``axis_name`` (a ``ProcessGroup``) syncs the batch statistics across
    its ranks, the SyncBatchNorm hook: each rank's E[x] and E[x^2] are
    stacked in one fp32 buffer and averaged over the group (one
    all-reduce, then the division by the group's size; the backward
    averages the cotangent the same way), and the running variance
    counts the group's elements. A mesh axis and its
    ``axis_index_groups`` (groupbn's ``bn_group``) are resolved into
    that group by the caller, with ``parallel_state.axis_group``, so
    ``axis_index_groups`` stays None here."""
    if isinstance(axis_name, str) or axis_index_groups is not None:
        raise ValueError(
            "batchnorm syncs over a ProcessGroup: resolve a mesh axis and "
            "its axis_index_groups with parallel_state.axis_group first")
    x32 = x.float()
    if train or state is None:
        axes = tuple(range(x.dim() - 1))
        mean = x32.mean(axes)
        mean_sq = (x32 * x32).mean(axes)
        n = x32.numel() // x32.shape[-1]
        if axis_name is not None:
            size = dist.get_world_size(axis_name)
            mean, mean_sq = _GroupMean.apply(torch.stack([mean, mean_sq]),
                                             axis_name, size)
            n = n * size
        var = mean_sq - mean * mean
        new_state = state
        if train and state is not None:
            with torch.no_grad():
                unbiased = var * (n / max(n - 1, 1))
                new_state = {
                    "mean": momentum * state["mean"] + (1 - momentum) * mean,
                    "var": momentum * state["var"]
                    + (1 - momentum) * unbiased}
    else:
        mean, var, new_state = state["mean"], state["var"], state
    y = (x32 - mean) * torch.rsqrt(var + eps)
    if params is not None:
        y = y * params["scale"] + params["bias"]
    return y.to(x.dtype), new_state


# -- embedding --------------------------------------------------------------

def init_embedding(generator: torch.Generator, vocab: int, features: int,
                   dtype: torch.dtype = torch.float32,
                   device: DeviceLike = None) -> dict:
    return {"embedding": trunc_normal(generator, (vocab, features),
                                      dtype=dtype, device=device)}


def embedding(params: dict, ids: torch.Tensor,
              dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Rows of the table for ``ids``; with ``dtype`` the table is cast
    before the lookup, as in JAX."""
    table = params["embedding"]
    if dtype is not None:
        table = table.to(dtype)
    return table[ids]

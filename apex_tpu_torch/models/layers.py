"""Minimal functional layers (counterpart of
``apex_tpu/models/layers.py``), the part BERT needs: params are dicts of
tensors, ``init_*(generator, ...) -> params`` plus an apply function.
Compute follows the caller's AMP policy (params cast outside). The
JAX ``dense`` also passes through the O1 ``cast_args`` op policy; O1 is
not ported, so here it is the plain product. ``conv`` and ``batchnorm``
wait for ResNet.

Random draws come from a ``torch.Generator`` on its own device and are
then moved to ``device``; they cannot reproduce JAX's threefry draws,
so parity tests carry JAX-initialised trees across instead
(``models._convert.params_from_jax``).
"""

import math
from typing import Sequence

import torch

from apex_tpu_torch.utils.platform import DeviceLike, resolve_device


def lecun_normal(generator: torch.Generator, shape: Sequence[int],
                 fan_in: int, dtype: torch.dtype = torch.float32,
                 device: DeviceLike = None) -> torch.Tensor:
    x = torch.randn(tuple(shape), generator=generator, dtype=dtype,
                    device=generator.device) * math.sqrt(1.0 / fan_in)
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
               out_features: int, dtype: torch.dtype = torch.float32,
               device: DeviceLike = None) -> dict:
    """kernel (in, out) from :func:`trunc_normal` (stddev 0.02), zero
    bias."""
    return {"kernel": trunc_normal(generator, (in_features, out_features),
                                   dtype=dtype, device=device),
            "bias": torch.zeros((out_features,), dtype=dtype,
                                device=resolve_device(device))}


def dense(params: dict, x: torch.Tensor) -> torch.Tensor:
    return (torch.matmul(x, params["kernel"].to(x.dtype))
            + params["bias"].to(x.dtype))


# -- embedding --------------------------------------------------------------

def init_embedding(generator: torch.Generator, vocab: int, features: int,
                   dtype: torch.dtype = torch.float32,
                   device: DeviceLike = None) -> dict:
    return {"embedding": trunc_normal(generator, (vocab, features),
                                      dtype=dtype, device=device)}


def embedding(params: dict, ids: torch.Tensor) -> torch.Tensor:
    return params["embedding"][ids]

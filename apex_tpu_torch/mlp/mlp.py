"""MLP block (counterpart of ``apex_tpu/mlp/mlp.py``): a chain of
linear layers with an activation after each, over a list of
``{"kernel", "bias"}`` dicts.

The reference's CUDA extension fuses the chain into one launch; the JAX
package leaves it to XLA and has no Pallas kernel for it, and here it is
plain PyTorch products. Each layer passes its operands through the O1 op
policy (``cast_args("dense", ...)``), so inside ``amp.autocast`` the
products run in the compute dtype. ``remat=True`` recomputes the chain
in the backward instead of keeping its activations
(``torch.utils.checkpoint``; the recompute re-enters the forward's
autocast context).
"""

import math
from typing import Any, Dict, List, Sequence

import torch
from torch.utils.checkpoint import checkpoint

from apex_tpu_torch.amp.autocast import autocast, autocast_dtype, cast_args
from apex_tpu_torch.utils.platform import DeviceLike, resolve_device

_ACTIVATIONS = {
    "none": lambda x: x,
    "relu": torch.relu,
    "sigmoid": torch.sigmoid,
}


def _uniform_init(generator: torch.Generator, fan_in: int, shape,
                   dtype: torch.dtype, device: DeviceLike) -> torch.Tensor:
    """The reference's init: uniform(-1/sqrt(fan_in), 1/sqrt(fan_in)),
    drawn on the generator's device, then moved to ``device``."""
    bound = 1.0 / math.sqrt(fan_in)
    x = torch.empty(tuple(shape), dtype=dtype, device=generator.device)
    x.uniform_(-bound, bound, generator=generator)
    return x.to(resolve_device(device))


class MLP:
    """``MLP([in, h1, ..., out])``: ``len(sizes) - 1`` linear layers with
    ``activation`` after each, the last included, as the reference
    applies it."""

    def __init__(self, mlp_sizes: Sequence[int], *, bias: bool = True,
                 activation: str = "relu", relu: bool = True,
                 params_dtype: torch.dtype = torch.float32,
                 remat: bool = False):
        if len(mlp_sizes) < 2:
            raise ValueError("MLP needs at least [in, out] sizes")
        if activation not in _ACTIVATIONS:
            raise ValueError(
                f"activation must be one of {sorted(_ACTIVATIONS)}")
        if not relu:  # the reference's back-compat flag
            activation = "none"
        self.sizes = list(mlp_sizes)
        self.use_bias = bias
        self.activation = activation
        self.params_dtype = params_dtype
        self.remat = remat

    def init(self, generator: torch.Generator,
             device: DeviceLike = None) -> List[Dict[str, Any]]:
        layers = []
        for fi, fo in zip(self.sizes[:-1], self.sizes[1:]):
            p = {"kernel": _uniform_init(generator, fi, (fi, fo),
                                          self.params_dtype, device)}
            if self.use_bias:
                p["bias"] = torch.zeros((fo,), dtype=self.params_dtype,
                                        device=resolve_device(device))
            layers.append(p)
        return layers

    def apply(self, params: List[Dict[str, Any]], x: torch.Tensor
              ) -> torch.Tensor:
        act = _ACTIVATIONS[self.activation]

        def chain(x):
            for p in params:
                xi, kernel = cast_args("dense", x, p["kernel"])
                x = torch.matmul(xi, kernel.to(xi.dtype))
                if "bias" in p:
                    x = x + p["bias"].to(x.dtype)
                x = act(x)
            return x

        if not self.remat:
            return chain(x)
        ac = autocast_dtype()

        def recomputed(x):
            with autocast(ac, enabled=ac is not None):
                return chain(x)

        return checkpoint(recomputed, x, use_reentrant=False)

    __call__ = apply

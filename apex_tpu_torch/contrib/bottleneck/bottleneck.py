"""The spatially parallel bottleneck block (counterpart of
``apex_tpu/contrib/bottleneck/bottleneck.py``; reference:
``apex/contrib/bottleneck/bottleneck.py``, ``Bottleneck`` /
``SpatialBottleneck``).

The ResNet bottleneck (1x1 reduce, 3x3, 1x1 expand, residual add,
stride 1, channels in == out) on NHWC tensors with HWIO kernels, through
the port's ``models.layers.conv``. The sharded variant takes this rank's
rows of H (the ``context`` axis): only the 3x3 convolution sees the
neighbours' pixels, so its input is widened by a one-row halo from each
H-neighbour (:func:`~apex_tpu_torch.contrib.peer_memory.halo_exchange_1d`)
and convolved VALID in H and SAME in W (padding ``[(0, 0), (1, 1)]``).
The halo's zero-fill at the outer boundary is SAME padding's zero ring,
so the sharded block computes the unsharded one's sums. The reference's
cuDNN workspace and frozen BatchNorm have no counterpart here, as in the
JAX package.
"""

import math

import torch

from apex_tpu_torch.contrib.peer_memory import halo_exchange_1d
from apex_tpu_torch.models.layers import conv
from apex_tpu_torch.transformer import parallel_state as ps
from apex_tpu_torch.utils.platform import DeviceLike, resolve_device


def init_spatial_bottleneck(generator: torch.Generator, channels: int,
                            bottleneck_channels: int,
                            dtype=torch.float32, device: DeviceLike = None):
    """He-initialized HWIO kernels ``w1``, ``w2``, ``w3`` of a stride-1
    bottleneck (no projection), drawn from ``generator`` on
    ``device``."""
    dev = resolve_device(device)

    def he(shape):
        fan_in = shape[0] * shape[1] * shape[2]
        return (torch.randn(shape, generator=generator, device=dev)
                * math.sqrt(2.0 / fan_in)).to(dtype)

    return {
        "w1": he((1, 1, channels, bottleneck_channels)),
        "w2": he((3, 3, bottleneck_channels, bottleneck_channels)),
        "w3": he((1, 1, bottleneck_channels, channels)),
    }


def _conv(x, w, padding):
    return conv({"kernel": w}, x, 1, padding)


def spatial_bottleneck(params, x: torch.Tensor) -> torch.Tensor:
    """The unsharded block on a whole NHWC tensor."""
    y = torch.relu(_conv(x, params["w1"], "VALID"))
    y = torch.relu(_conv(y, params["w2"], "SAME"))
    y = _conv(y, params["w3"], "VALID")
    return torch.relu(x + y)


def spatial_parallel_bottleneck(params, x: torch.Tensor, *,
                                axis_name: str = ps.CONTEXT_AXIS,
                                ) -> torch.Tensor:
    """The same block on this rank's rows of H (inside
    ``parallel_state.shard_map`` over ``axis_name``): the 3x3
    convolution's input widened by a one-row halo from each neighbour;
    the 1x1 convolutions and the residual stay local."""
    y = torch.relu(_conv(x, params["w1"], "VALID"))
    y = halo_exchange_1d(y, 1, axis=1, axis_name=axis_name)
    y = torch.relu(_conv(y, params["w2"], [(0, 0), (1, 1)]))
    y = _conv(y, params["w3"], "VALID")
    return torch.relu(x + y)

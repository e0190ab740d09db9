"""ResNet (v1.5, NHWC), counterpart of ``apex_tpu/models/resnet.py``: the
``examples/imagenet`` model. Params and running BatchNorm statistics are
two dict trees with the JAX package's keys and leaf shapes (conv kernels
HWIO), threaded explicitly: ``apply_resnet`` returns the new statistics.

The convolutions are ``F.conv2d`` (cuDNN on the card), BatchNorm plain
tensor ops in fp32, the stem's max pool ``F.max_pool2d``: in the JAX
package they are XLA ops outside any Pallas kernel.
"""

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from apex_tpu_torch.models import layers as L
from apex_tpu_torch.utils.platform import DeviceLike, resolve_device

# (block counts, bottleneck?) per variant
_SPECS = {
    10: ((1, 1, 1, 1), False),  # test tier: the smallest resnet
    18: ((2, 2, 2, 2), False),
    34: ((3, 4, 6, 3), False),
    50: ((3, 4, 6, 3), True),
    101: ((3, 4, 23, 3), True),
    152: ((3, 8, 36, 3), True),
}


def init_resnet(generator: torch.Generator, depth: int = 50,
                num_classes: int = 1000, dtype: torch.dtype = torch.float32,
                device: DeviceLike = None) -> Tuple[Dict, Dict]:
    """Returns (params, batch_stats), drawn from ``generator`` (on its own
    device) and placed on ``device`` (None: the card)."""
    dev = resolve_device(device)
    blocks, bottleneck = _SPECS[depth]

    def conv(i, o, k):
        return L.init_conv(generator, i, o, (k, k), dtype, dev)

    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    params["stem_conv"] = conv(3, 64, 7)
    params["stem_bn"], stats["stem_bn"] = L.init_batchnorm(64, dev)
    in_ch = 64
    for si, n in enumerate(blocks):
        width = 64 * (2 ** si)
        out_ch = width * (4 if bottleneck else 1)
        for bi in range(n):
            bp: Dict[str, Any] = {}
            bs: Dict[str, Any] = {}
            stride = 2 if (si > 0 and bi == 0) else 1
            if bottleneck:
                convs = ((in_ch, width, 1), (width, width, 3),
                         (width, out_ch, 1))
            else:
                convs = ((in_ch, width, 3), (width, out_ch, 3))
            for ci, (i, o, k) in enumerate(convs, 1):
                bp[f"conv{ci}"] = conv(i, o, k)
                bp[f"bn{ci}"], bs[f"bn{ci}"] = L.init_batchnorm(o, dev)
            if stride != 1 or in_ch != out_ch:
                bp["proj_conv"] = conv(in_ch, out_ch, 1)
                bp["proj_bn"], bs["proj_bn"] = L.init_batchnorm(out_ch, dev)
            params[f"layer{si + 1}_{bi}"] = bp
            stats[f"layer{si + 1}_{bi}"] = bs
            in_ch = out_ch
    params["fc"] = L.init_dense(generator, in_ch, num_classes,
                                init=L.lecun_normal, dtype=dtype, device=dev)
    return params, stats


def _block(bp, bs, x, *, stride, bottleneck, train, axis_name, momentum):
    ns = {}
    y = x
    n_convs = 3 if bottleneck else 2
    for ci in range(1, n_convs + 1):
        # the strided conv: the 3x3 of a bottleneck, the first of a basic
        s = stride if ci == (2 if bottleneck else 1) else 1
        y = L.conv(bp[f"conv{ci}"], y, s)
        y, ns[f"bn{ci}"] = L.batchnorm(bp[f"bn{ci}"], bs[f"bn{ci}"], y,
                                       train=train, axis_name=axis_name,
                                       momentum=momentum)
        if ci < n_convs:
            y = F.relu(y)
    if "proj_conv" in bp:
        sc = L.conv(bp["proj_conv"], x, stride)
        sc, ns["proj_bn"] = L.batchnorm(bp["proj_bn"], bs["proj_bn"], sc,
                                        train=train, axis_name=axis_name,
                                        momentum=momentum)
    else:
        sc = x
    return F.relu(y + sc), ns


def apply_resnet(params: Dict, stats: Dict, x: torch.Tensor,
                 depth: int = 50, *, train: bool = True,
                 axis_name: Any = None, momentum: float = 0.9
                 ) -> Tuple[torch.Tensor, Dict]:
    """x: (N, H, W, 3). Returns (logits, new_batch_stats). ``axis_name``
    (a ``ProcessGroup``) syncs every BatchNorm's batch statistics across
    its ranks (``layers.batchnorm``); ``parallel.convert_syncbn_model``
    binds a mesh axis's group."""
    blocks, bottleneck = _SPECS[depth]
    new_stats: Dict[str, Any] = {}
    y = L.conv(params["stem_conv"], x, 2)
    y, new_stats["stem_bn"] = L.batchnorm(
        params["stem_bn"], stats["stem_bn"], y, train=train,
        axis_name=axis_name, momentum=momentum)
    y = F.relu(y)
    # reduce_window max, 3x3 stride 2, (1, 1) padding of -inf
    y = F.max_pool2d(y.permute(0, 3, 1, 2), 3, 2, padding=1).permute(
        0, 2, 3, 1)
    for si, n in enumerate(blocks):
        for bi in range(n):
            name = f"layer{si + 1}_{bi}"
            y, new_stats[name] = _block(
                params[name], stats[name], y,
                stride=2 if (si > 0 and bi == 0) else 1,
                bottleneck=bottleneck, train=train, axis_name=axis_name,
                momentum=momentum)
    y = y.mean(dim=(1, 2))
    return L.dense(params["fc"], y), new_stats


def cross_entropy_loss(logits: torch.Tensor,
                       labels: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -torch.take_along_dim(logp, labels[:, None].long(), dim=-1).mean()

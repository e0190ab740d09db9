"""Parameter trees carried across from the JAX package."""

from typing import Any, Optional

import numpy as np
import torch

from apex_tpu_torch.utils.platform import DeviceLike, resolve_device


def params_from_jax(tree: Any, device: DeviceLike,
                    dtype: Optional[torch.dtype] = None) -> Any:
    """Map a JAX parameter tree, given as numpy arrays, onto the port's
    tree with the same keys and the same list layout (BERT keeps its
    encoder as a list of per-layer dicts; ResNet's params and BatchNorm
    statistics cross as two dict trees). bf16 leaves (numpy dtype
    ``bfloat16``) cross as a uint16 view; ``dtype`` optionally casts
    floating leaves."""
    dev = resolve_device(device)

    def leaf(a):
        a = np.array(a)  # a writable copy: jax hands out read-only views
        if a.dtype.name == "bfloat16":
            t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(a)
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        return t.to(dev)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        return leaf(node)

    return walk(tree)

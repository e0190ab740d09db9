"""Weight-only int8 parameter trees (counterpart of
``apex_tpu/quant/params.py``): quantize once, serve from int8.

``quantize_params`` rewrites a GPT parameter tree: every matmul kernel
(the four per-layer linears plus the tied word table) becomes an int8
leaf AT THE SAME PATH with a sibling ``scale`` leaf, per-output-channel
symmetric fp32 scales with the contraction axis reduced away:

====================  ==============  ===========  ==============
leaf                  kernel shape    contraction  scale shape
====================  ==============  ===========  ==============
layers/*/kernel       (L, K, N)       axis -2      (L, N)
embedding/word        (V, h)          axis -1      (V,)
====================  ==============  ===========  ==============

Biases, layer norms and the learned position table stay as they are.
The arithmetic repeats the JAX package's operation for operation, so a
tree quantized here equals the JAX one bit for bit.
"""

import re
from typing import Any, Dict, Optional, Tuple

import torch

# path-regex -> contraction axis of the dot that consumes the leaf
# (layers/* kernels carry the leading stacked-L dim, hence -2)
_QUANT_AXES = (
    (r"(^|/)embedding/word/embedding$", -1),
    (r"(^|/)layers/(qkv|out|fc1|fc2)/kernel$", -2),
)


def quantize_tensor(w: torch.Tensor, axis: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel symmetric int8: amax over the contraction
    ``axis``, round half to even, fp32 scales. Returns ``(q int8, scale
    fp32)`` with ``scale.shape = w.shape`` minus ``axis``. Zero channels
    keep scale 0 and quantize to exact zeros."""
    fw = w.float()
    amax = fw.abs().amax(dim=axis)
    scale = amax / 127.0
    safe = torch.where(scale > 0, scale, torch.ones((), device=w.device))
    q = torch.round(fw / safe.unsqueeze(axis)).clamp(-127, 127)
    return q.to(torch.int8), scale


def dequantize_tensor(q: torch.Tensor, scale: torch.Tensor, axis: int,
                      dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Inverse of :func:`quantize_tensor` (up to the rounding step)."""
    return (q.float() * scale.float().unsqueeze(axis)).to(dtype)


def _quant_axis(path: str) -> Optional[int]:
    for pat, axis in _QUANT_AXES:
        if re.search(pat, path):
            return axis
    return None


def quantize_params(params: Dict[str, Any]) -> Dict[str, Any]:
    """GPT param tree -> weight-only int8 tree (kernel leaves int8 at
    their original paths + sibling fp32 ``scale`` leaves; everything
    else passed through as it is)."""

    def rewrite(subtree, prefix):
        if not isinstance(subtree, dict):
            return subtree
        out = {}
        for name, child in subtree.items():
            path = f"{prefix}/{name}" if prefix else name
            axis = None if isinstance(child, dict) else _quant_axis(path)
            if axis is not None:
                out[name], out["scale"] = quantize_tensor(child, axis)
            else:
                out[name] = rewrite(child, path)
        return out

    return rewrite(params, "")


def is_quantized_tree(params: Dict[str, Any]) -> bool:
    """True when ``params`` carries the weight-only int8 layout (the
    serving engine detects it and builds the w8 steps)."""
    word = params.get("embedding", {}).get("word", {})
    return "scale" in word

"""The fp16 helpers over param trees (counterpart of
``apex_tpu/fp16_utils/fp16util.py``).

The reference mutates ``nn.Module``s (``network_to_half``,
``BN_convert_float``) and copies between ``.data`` buffers; the port's
params are dict trees, so each helper is a tree transform on the amp
policy, as in the JAX package. New code should use ``amp.initialize``
(O2), as the reference's documentation says.
"""

from typing import Any, Tuple

import torch

from apex_tpu_torch.amp import policy as _policy
from apex_tpu_torch.utils.tree import tree_map


def _is_float(x) -> bool:
    return isinstance(x, torch.Tensor) and x.is_floating_point()


def tofp16(params: Any, dtype: torch.dtype = torch.float16) -> Any:
    """Every floating leaf to ``dtype`` (the reference's ``tofp16``)."""
    return _policy.cast_params(params, dtype)


def network_to_half(params: Any, dtype: torch.dtype = torch.float16) -> Any:
    """Floating leaves to ``dtype`` but the normalization leaves, which
    stay fp32 (``tofp16`` + ``BN_convert_float``; the norm paths of amp's
    ``keep_batchnorm_fp32``)."""
    return _policy.cast_params(params, dtype, keep_batchnorm_fp32=True)


def prep_param_lists(params: Any) -> Tuple[Any, Any]:
    """``(model params, fp32 master copy)``."""
    return params, _policy.master_params(params)


def master_params_to_model_params(model_params: Any, master: Any) -> Any:
    """The master values cast to the model params' dtypes."""
    return tree_map(lambda mp, ma: ma.to(mp.dtype) if _is_float(mp) else mp,
                    model_params, master)


def model_grads_to_master_grads(grads: Any) -> Any:
    """Floating gradients to fp32 for the master update."""
    return tree_map(lambda g: g.float() if _is_float(g) else g, grads)

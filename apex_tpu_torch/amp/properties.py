"""Opt-level property system (counterpart of ``apex_tpu/amp/properties.py``).

The five knobs keep the reference's names and meanings; "half" is
bfloat16. ``cast_model_type`` and ``keep_batchnorm_fp32`` drive the
model cast, ``loss_scale`` the :class:`LossScaler`; as in the JAX
package the master weights are the caller's fp32 tree.
"""

import dataclasses
from typing import Optional, Union

import torch


@dataclasses.dataclass
class Properties:
    enabled: bool = True
    opt_level: Optional[str] = None
    cast_model_type: Optional[torch.dtype] = None
    patch_torch_functions: bool = False
    keep_batchnorm_fp32: Optional[bool] = None
    master_weights: Optional[bool] = None
    loss_scale: Union[float, str] = 1.0

    def _update_options_dict(self, new_options: dict) -> None:
        for k, v in new_options.items():
            if not hasattr(self, k):
                raise ValueError(f"Tried to set unexpected option {k!r}")
            setattr(self, k, v)


HALF = torch.bfloat16


def _preset(opt_level, cast_model_type, patch, keep_bn, master, scale):
    def apply(properties: Properties) -> Properties:
        properties.enabled = True
        properties.opt_level = opt_level
        properties.cast_model_type = cast_model_type
        properties.patch_torch_functions = patch
        properties.keep_batchnorm_fp32 = keep_bn
        properties.master_weights = master
        properties.loss_scale = scale
        return properties
    return apply


opt_levels = {
    # pure reduced precision
    "O3": _preset("O3", HALF, False, False, False, 1.0),
    # half model + fp32 norms + fp32 master weights + dynamic scale
    "O2": _preset("O2", HALF, False, True, True, "dynamic"),
    # per-op autocast
    "O1": _preset("O1", None, True, None, None, "dynamic"),
    # pure fp32
    "O0": _preset("O0", torch.float32, False, False, False, 1.0),
}

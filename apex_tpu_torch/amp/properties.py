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

    @property
    def half_dtype(self):
        return self.cast_model_type


HALF = torch.bfloat16


class _OptLevel:
    """An opt level: ``__call__`` sets the five knobs on a
    :class:`Properties` (the reference's O0-O3 classes)."""

    brief = ""
    _knobs: tuple = ()

    def __call__(self, properties: Properties) -> Properties:
        (properties.cast_model_type, properties.patch_torch_functions,
         properties.keep_batchnorm_fp32, properties.master_weights,
         properties.loss_scale) = self._knobs
        properties.enabled = True
        properties.opt_level = type(self).__name__
        return properties


class O3(_OptLevel):
    """FP16/BF16 everything ("speed of light" baseline)."""

    brief = "O3: Pure reduced precision (bf16)."
    _knobs = (HALF, False, False, False, 1.0)


class O2(_OptLevel):
    """Half model + fp32 batchnorm + fp32 master weights + dynamic scale."""

    brief = "O2: cast model to reduced precision, keep master weights in fp32."
    _knobs = (HALF, False, True, True, "dynamic")


class O1(_OptLevel):
    """Op-policy autocast (the reference's patch-torch-functions mode)."""

    brief = "O1: per-op autocast via the amp op-policy lists."
    _knobs = (None, True, None, None, "dynamic")


class O0(_OptLevel):
    """Pure fp32 (the off switch that still goes through the amp API)."""

    brief = "O0: pure fp32."
    _knobs = (torch.float32, False, False, False, 1.0)


opt_levels = {"O3": O3(), "O2": O2(), "O1": O1(), "O0": O0()}

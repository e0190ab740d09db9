"""AMP frontend, inference subset (counterpart of
``apex_tpu/amp/frontend.py``): ``initialize`` builds an :class:`Amp`
handle from an opt level plus overrides, and ``Amp.cast_model`` casts a
param tree. The loss scaler and the scaled ``value_and_grad`` come with
the training slice.
"""

import logging
from typing import Any, Optional

from apex_tpu_torch.amp import policy as _policy
from apex_tpu_torch.amp.properties import Properties, opt_levels


class Amp:
    """An opt level's Properties plus the model cast."""

    def __init__(self, properties: Properties):
        self.properties = properties

    def cast_model(self, params: Any) -> Any:
        """O0/O2/O3 model cast (O1 leaves the params as they are)."""
        p = self.properties
        if p.cast_model_type is None:
            return params
        return _policy.cast_params(
            params, p.cast_model_type,
            keep_batchnorm_fp32=bool(p.keep_batchnorm_fp32))


def initialize(opt_level: str = "O1", *, cast_model_type=None,
               keep_batchnorm_fp32: Optional[bool] = None,
               master_weights: Optional[bool] = None, loss_scale=None,
               enabled: bool = True, verbosity: int = 1) -> Amp:
    """Build an :class:`Amp` handle from an opt level + overrides
    (``apex.amp.initialize``'s knobs; nothing is mutated)."""
    if opt_level not in opt_levels:
        raise ValueError(
            f"Unexpected optimization level {opt_level!r} "
            "(options are 'O0', 'O1', 'O2', 'O3').")
    props = opt_levels[opt_level](Properties())
    if enabled:
        overrides = {
            "cast_model_type": cast_model_type,
            "keep_batchnorm_fp32": keep_batchnorm_fp32,
            "master_weights": master_weights,
            "loss_scale": loss_scale,
        }
        props._update_options_dict(
            {k: v for k, v in overrides.items() if v is not None})
    else:
        props.enabled = False
        props.patch_torch_functions = False
        props.cast_model_type = None
        props.master_weights = False
        props.loss_scale = 1.0
    if verbosity > 0:
        logging.getLogger("apex_tpu_torch").info(
            "amp.initialize: opt_level=%s properties=%s", opt_level, props)
    return Amp(props)

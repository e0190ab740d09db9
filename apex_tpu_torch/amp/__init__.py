from apex_tpu_torch.amp.frontend import Amp, initialize  # noqa: F401
from apex_tpu_torch.amp.policy import (  # noqa: F401
    cast_inputs,
    cast_params,
    default_norm_predicate,
    master_params,
    model_params_from_master,
)
from apex_tpu_torch.amp.properties import Properties, opt_levels  # noqa: F401
from apex_tpu_torch.amp.scaler import (  # noqa: F401
    LossScaler,
    LossScalerState,
    apply_if_finite,
)

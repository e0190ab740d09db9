"""Legacy fp16 utilities (counterpart of ``apex_tpu/fp16_utils``)."""

from apex_tpu_torch.fp16_utils.fp16_optimizer import (  # noqa: F401
    FP16_Optimizer,
    FP16OptimizerState,
)
from apex_tpu_torch.fp16_utils.fp16util import (  # noqa: F401
    master_params_to_model_params,
    model_grads_to_master_grads,
    network_to_half,
    prep_param_lists,
    tofp16,
)

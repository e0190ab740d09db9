"""Fused optimizers: FusedAdam, FusedLAMB, FusedSGD, FusedAdagrad and
FusedNovoGrad, each on the tree path and the flat path. Functional API:
``state = opt.init(params)``; ``params, state = opt.step(grads, params,
state, found_inf=...)``."""

from apex_tpu_torch.optimizers.fused_adagrad import (  # noqa: F401
    AdagradState, FusedAdagrad,
)
from apex_tpu_torch.optimizers.fused_adam import AdamState, FusedAdam  # noqa: F401
from apex_tpu_torch.optimizers.fused_lamb import FusedLAMB, LambState  # noqa: F401
from apex_tpu_torch.optimizers.fused_novograd import (  # noqa: F401
    FusedNovoGrad, NovoGradState,
)
from apex_tpu_torch.optimizers.fused_sgd import FusedSGD, SGDState  # noqa: F401

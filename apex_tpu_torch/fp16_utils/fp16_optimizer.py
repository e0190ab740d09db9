"""FP16_Optimizer, the legacy master-weights wrapper (counterpart of
``apex_tpu/fp16_utils/fp16_optimizer.py``).

The wrapper owns an :class:`FP16OptimizerState`: the fp32 master tree,
the wrapped optimizer's state and the loss scaler's state. The
reference's ``backward(loss)`` is :meth:`FP16_Optimizer.scale_loss`
(differentiate the value it returns); :meth:`FP16_Optimizer.step` takes
the model-dtype gradients of that scaled loss, makes them fp32, unscales
them and checks them for overflow, steps the wrapped optimizer on the
masters (skipped on an overflow, by its ``found_inf``), advances the
scaler and casts the masters back to the model's dtypes. The wrapped
optimizer is one of ``apex_tpu_torch.optimizers``. Nothing reads a
value back to the host.
"""

from typing import Any, NamedTuple, Optional, Tuple, Union

import torch

from apex_tpu_torch.amp.scaler import LossScaler, LossScalerState
from apex_tpu_torch.fp16_utils.fp16util import (
    master_params_to_model_params,
    model_grads_to_master_grads,
    prep_param_lists,
)
from apex_tpu_torch.utils.tree import tree_leaves


class FP16OptimizerState(NamedTuple):
    master: Any
    inner: Any
    scaler: LossScalerState


class FP16_Optimizer:
    def __init__(self, optimizer,
                 static_loss_scale: Union[float, str] = 1.0,
                 dynamic_loss_scale: bool = False,
                 dynamic_loss_args: Optional[dict] = None,
                 verbose: bool = False):
        self.optimizer = optimizer
        if dynamic_loss_scale:
            self.loss_scaler = LossScaler("dynamic",
                                          **(dynamic_loss_args or {}))
        else:
            self.loss_scaler = LossScaler(float(static_loss_scale))
        self.verbose = verbose

    # -- state ----------------------------------------------------------
    def init(self, model_params: Any) -> FP16OptimizerState:
        """The master copy, the wrapped optimizer's state over it, and the
        scaler's state, on the params' device."""
        _, master = prep_param_lists(model_params)
        return FP16OptimizerState(
            master=master, inner=self.optimizer.init(master),
            scaler=self.loss_scaler.init_state(
                tree_leaves(model_params)[0].device))

    def loss_scale(self, state: FP16OptimizerState) -> torch.Tensor:
        return self.loss_scaler.loss_scale(state.scaler)

    # -- the backward()/step() pair -------------------------------------
    def scale_loss(self, loss: torch.Tensor,
                   state: FP16OptimizerState) -> torch.Tensor:
        """The loss to differentiate (the reference scales it before
        ``.backward()`` so fp16 gradients do not underflow)."""
        return self.loss_scaler.scale(loss, state.scaler)

    def step(self, grads: Any, model_params: Any,
             state: FP16OptimizerState, **step_kwargs
             ) -> Tuple[Any, FP16OptimizerState]:
        """``grads`` of the scaled loss, in the model's dtypes. Returns
        ``(new model params, new state)``; on an overflow the inner step
        is skipped (params and masters stay as they were) and a dynamic
        scale halves."""
        master_grads = model_grads_to_master_grads(grads)
        master_grads, found_inf = self.loss_scaler.unscale(
            master_grads, state.scaler)
        new_master, new_inner = self.optimizer.step(
            master_grads, state.master, state.inner, found_inf=found_inf,
            **step_kwargs)
        new_scaler = self.loss_scaler.update_scale(state.scaler, found_inf)
        new_model = master_params_to_model_params(model_params, new_master)
        return new_model, FP16OptimizerState(
            master=new_master, inner=new_inner, scaler=new_scaler)

    # -- checkpoints ----------------------------------------------------
    def state_dict(self, state: FP16OptimizerState) -> dict:
        """The state as a dict of tensors, the scaler's dynamic state
        included."""
        return {"master": state.master, "inner": state.inner,
                "scaler": {"loss_scale": state.scaler.loss_scale,
                           "unskipped": state.scaler.unskipped,
                           "overflows": state.scaler.overflows}}

    def load_state_dict(self, d: dict) -> FP16OptimizerState:
        return FP16OptimizerState(
            master=d["master"], inner=d["inner"],
            scaler=LossScalerState(**d["scaler"]))

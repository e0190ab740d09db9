"""AMP frontend (counterpart of ``apex_tpu/amp/frontend.py``):
``initialize`` builds an :class:`Amp` handle from an opt level plus
overrides; the handle casts a param tree and carries the loss scaler.

    h = amp.initialize("O2", loss_scale="dynamic")
    state = h.init_state()                       # scaler state, on the card
    p = h.cast_model(master)                     # O2: bf16 but the norms
    x = h.cast_input(x)                          # O2: floating inputs bf16
    loss, grads, found_inf, state = h.value_and_grad(loss_fn)(p, state, x)
    master, opt_state = opt.step(grads, master, opt_state,
                                 found_inf=found_inf)

O1 leaves the params fp32 and casts per op instead: run the forward
inside ``h.autocast()``, where the package's dense, convolution and
attention products take the compute dtype (``amp.lists``).
``num_losses=N`` gives N independent scaler states: ``init_state``
returns a tuple and the reference's ``loss_id`` is plain indexing.
"""

import logging
import warnings
from typing import Any, Callable, Optional

import torch

from apex_tpu_torch.amp import policy as _policy
from apex_tpu_torch.amp.autocast import autocast
from apex_tpu_torch.amp.properties import Properties, opt_levels
from apex_tpu_torch.amp.scaler import LossScaler, LossScalerState
from apex_tpu_torch.utils.platform import DeviceLike
from apex_tpu_torch.utils.tree import tree_leaves, tree_map


class Amp:
    """An opt level's Properties, the model cast and a LossScaler
    (``num_losses`` independent scaler states)."""

    def __init__(self, properties: Properties, num_losses: int = 1):
        self.properties = properties
        self.num_losses = int(num_losses)
        self.scaler = LossScaler(loss_scale=properties.loss_scale)

    def cast_model(self, params: Any, precast: Any = None) -> Any:
        """O0/O2/O3 model cast (O1 leaves the params as they are).
        ``precast`` is an optimizer-emitted compute tree, taken leaf for
        leaf where its dtype is already the target."""
        p = self.properties
        if p.cast_model_type is None:
            return params
        return _policy.cast_params(
            params, p.cast_model_type,
            keep_batchnorm_fp32=bool(p.keep_batchnorm_fp32),
            precast=precast)

    def cast_input(self, batch: Any) -> Any:
        """The input cast: floating tensors of ``batch`` to
        ``cast_model_type`` (fp32 under O0, as the reference casts them
        there too; bf16 under O2); O1 leaves the batch as it is."""
        p = self.properties
        if p.cast_model_type is None:
            return batch
        return _policy.cast_inputs(batch, p.cast_model_type)

    def master_params(self, params: Any) -> Any:
        """The fp32 master copy (the tree itself without
        ``master_weights``)."""
        if not self.properties.master_weights:
            return params
        return _policy.master_params(params)

    def autocast(self):
        """The O1 context: op-policy casting for the package's ops in
        scope, in ``cast_model_type`` or bf16; a no-op context unless the
        opt level patches functions (O1)."""
        p = self.properties
        dtype = p.cast_model_type or torch.bfloat16
        return autocast(dtype=dtype, enabled=bool(p.patch_torch_functions))

    # -- scaler ---------------------------------------------------------
    def init_state(self, device: DeviceLike = None):
        """One scaler state, or a tuple of ``num_losses`` of them."""
        if self.num_losses == 1:
            return self.scaler.init_state(device)
        return tuple(self.scaler.init_state(device)
                     for _ in range(self.num_losses))

    def scale_loss(self, loss, state: LossScalerState):
        return self.scaler.scale(loss, state)

    def unscale(self, grads, state: LossScalerState):
        return self.scaler.unscale(grads, state)

    def update_scale(self, state: LossScalerState, found_inf):
        return self.scaler.update_scale(state, found_inf)

    def value_and_grad(self, loss_fn: Callable,
                       has_aux: bool = False) -> Callable:
        """Scaled value-and-grad: gradients of the *scaled* loss,
        unscaled, and the scaler state advanced.

        Returned callable: ``(params, state, *args, **kw) -> (value,
        grads, found_inf, new_state)``, the JAX tuple, where ``value`` is
        the unscaled loss, or with ``has_aux`` (``loss_fn`` returning
        ``(loss, aux)``) the pair ``(loss, aux)``, aux detached. The
        gradients are with respect to ``params`` as given (the compute
        tree, bf16 leaves included): its floating leaves are detached and
        marked ``requires_grad``. A leaf the loss never reaches gets a
        zero gradient, as ``jax.grad`` gives it."""

        def wrapped(params, state: LossScalerState, *args, **kw):
            def leaf(x):
                if isinstance(x, torch.Tensor) and x.is_floating_point():
                    return x.detach().requires_grad_(True)
                return x

            p = tree_map(leaf, params)
            with torch.enable_grad():
                out = loss_fn(p, *args, **kw)
                loss, aux = out if has_aux else (out, None)
                xs = [x for x in tree_leaves(p)
                      if isinstance(x, torch.Tensor) and x.requires_grad]
                gs = torch.autograd.grad(self.scaler.scale(loss, state), xs,
                                         allow_unused=True)
            by_id = {id(x): torch.zeros_like(x) if g is None else g
                     for x, g in zip(xs, gs)}
            grads = tree_map(lambda x: by_id.get(id(x), x), p)
            grads, found_inf = self.scaler.unscale(grads, state)
            new_state = self.scaler.update_scale(state, found_inf)
            if not has_aux:
                return loss.detach(), grads, found_inf, new_state
            aux = tree_map(lambda x: x.detach()
                           if isinstance(x, torch.Tensor) else x, aux)
            return (loss.detach(), aux), grads, found_inf, new_state

        return wrapped

    # -- checkpointing (the reference's ``amp.state_dict``) -------------
    def state_dict(self, state) -> dict:
        """One ``loss_scalerI`` entry a scaler state (a single state is
        scaler 0); host values."""
        states = state if isinstance(state, (list, tuple)) else (state,)
        return {f"loss_scaler{i}": self.scaler.state_dict(s)
                for i, s in enumerate(states)}

    def load_state_dict(self, d: dict, device: DeviceLike = None):
        """Inverse of :meth:`state_dict`. A count of ``loss_scaler``
        entries other than ``num_losses`` warns and loads the overlap:
        surplus entries are dropped, missing scalers start from a fresh
        state (the reference's ``zip`` truncates silently)."""
        prefix = "loss_scaler"
        keys = sorted((k for k in d if k.startswith(prefix)
                       and k[len(prefix):].isdigit()),
                      key=lambda k: int(k[len(prefix):]))
        if len(keys) != self.num_losses:
            warnings.warn(
                f"amp state_dict has {len(keys)} loss_scaler entries but "
                f"this handle was initialized with num_losses="
                f"{self.num_losses}; loading the overlap — surplus "
                "checkpoint entries are ignored, missing scalers start "
                "from a fresh init_state()", stacklevel=2)
        states = tuple(
            self.scaler.load_state_dict(d[keys[i]], device)
            if i < len(keys) else self.scaler.init_state(device)
            for i in range(self.num_losses))
        return states[0] if self.num_losses == 1 else states


def initialize(opt_level: str = "O1", *, cast_model_type=None,
               keep_batchnorm_fp32: Optional[bool] = None,
               master_weights: Optional[bool] = None, loss_scale=None,
               enabled: bool = True, verbosity: int = 1,
               num_losses: int = 1) -> Amp:
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
    return Amp(props, num_losses=num_losses)

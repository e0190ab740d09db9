"""Static and dynamic loss scaling (counterpart of
``apex_tpu/amp/scaler.py``): start at 2^16, halve on inf/nan gradients
(and skip the step), double after 2000 clean steps.

The scaler state (:class:`LossScalerState`) is three 0-d tensors on the
device, and ``found_inf`` is a 0-d bool tensor there too. Nothing here
reads a value back to the host: the scale update and the skip are
``torch.where`` selects, so a training step makes no host sync on them.
"""

import dataclasses
from typing import Any, Optional, Tuple, Union

import torch

from apex_tpu_torch.utils.platform import DeviceLike, resolve_device
from apex_tpu_torch.utils.tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class LossScalerState:
    loss_scale: torch.Tensor  # f32 scalar
    unskipped: torch.Tensor   # i32 scalar: clean steps since last rescale
    overflows: torch.Tensor   # i32 scalar: total overflow count


def _wide(dtype: torch.dtype) -> torch.dtype:
    return torch.promote_types(dtype, torch.float32)  # f64 stays f64


def _leaf_finite(x: torch.Tensor) -> torch.Tensor:
    """All-finite check of one leaf, as a 0-d bool tensor. Like the JAX
    version it also compares magnitudes against the storage dtype's max,
    so an overflow that exists only in the storage dtype counts (XLA may
    elide an f32->f16->f32 round trip; eager PyTorch does not, but the
    check costs one reduction and keeps the contract)."""
    wide = _wide(x.dtype)
    xf = x.to(wide)
    finite = torch.isfinite(xf).all()
    if x.is_floating_point() and \
            torch.finfo(x.dtype).max < torch.finfo(wide).max:
        finite = finite & (xf.abs() <= torch.finfo(x.dtype).max).all()
    return finite


def _all_finite(tree: Any) -> torch.Tensor:
    leaves = tree_leaves(tree)
    if not leaves:
        return torch.tensor(True)
    return torch.stack([_leaf_finite(l) for l in leaves]).all()


class LossScaler:
    """Functional loss scaler: ``loss_scale="dynamic"`` enables the
    dynamic policy; a float pins the scale."""

    def __init__(self, loss_scale: Union[float, str] = "dynamic",
                 init_scale: float = 2.0 ** 16, scale_factor: float = 2.0,
                 scale_window: int = 2000,
                 min_loss_scale: Optional[float] = None,
                 max_loss_scale: float = 2.0 ** 24):
        self.dynamic = loss_scale == "dynamic"
        self._init_scale = init_scale if self.dynamic else float(loss_scale)
        self.scale_factor = scale_factor
        self.scale_window = scale_window
        self.min_loss_scale = (
            min_loss_scale if min_loss_scale is not None else 1.0)
        self.max_loss_scale = max_loss_scale

    # -- state ----------------------------------------------------------
    def init_state(self, device: DeviceLike = None) -> LossScalerState:
        dev = resolve_device(device)
        return LossScalerState(
            loss_scale=torch.tensor(self._init_scale, dtype=torch.float32,
                                    device=dev),
            unskipped=torch.tensor(0, dtype=torch.int32, device=dev),
            overflows=torch.tensor(0, dtype=torch.int32, device=dev))

    def loss_scale(self, state: LossScalerState) -> torch.Tensor:
        return state.loss_scale

    # -- hot path -------------------------------------------------------
    def scale(self, loss: torch.Tensor, state: LossScalerState
              ) -> torch.Tensor:
        """The scaled loss, in at least fp32 (2^16 is past fp16's max)."""
        target = _wide(loss.dtype)
        return loss.to(target) * state.loss_scale.to(target)

    def unscale(self, grads: Any, state: LossScalerState
                ) -> Tuple[Any, torch.Tensor]:
        """(unscaled grads, found_inf). Overflow is detected on the
        incoming scaled grads, in their own storage dtype."""
        inv = 1.0 / state.loss_scale
        found_inf = torch.logical_not(_all_finite(grads))

        def unscale_leaf(g):
            wide = _wide(g.dtype)
            return (g.to(wide) * inv.to(wide)).to(g.dtype)

        return tree_map(unscale_leaf, grads), found_inf

    def update_scale(self, state: LossScalerState,
                     found_inf: torch.Tensor) -> LossScalerState:
        """Dynamic policy: overflow -> scale / 2 and reset the window;
        ``scale_window`` clean steps -> scale * 2."""
        if not self.dynamic:
            return state
        on_overflow = torch.clamp(state.loss_scale / self.scale_factor,
                                  min=self.min_loss_scale)
        unskipped = torch.where(found_inf, torch.zeros_like(state.unskipped),
                                state.unskipped + 1)
        window_hit = unskipped >= self.scale_window
        grown = torch.clamp(state.loss_scale * self.scale_factor,
                            max=self.max_loss_scale)
        new_scale = torch.where(
            found_inf, on_overflow,
            torch.where(window_hit, grown, state.loss_scale))
        unskipped = torch.where(window_hit, torch.zeros_like(unskipped),
                                unskipped)
        return LossScalerState(
            loss_scale=new_scale, unskipped=unskipped.to(torch.int32),
            overflows=state.overflows + found_inf.to(torch.int32))

    # -- checkpointing --------------------------------------------------
    def state_dict(self, state: LossScalerState) -> dict:
        """Host values (this is where a checkpoint syncs)."""
        return {"loss_scale": float(state.loss_scale),
                "unskipped": int(state.unskipped),
                "overflows": int(state.overflows)}

    def load_state_dict(self, d: dict, device: DeviceLike = None
                        ) -> LossScalerState:
        dev = resolve_device(device)
        return LossScalerState(
            loss_scale=torch.tensor(d["loss_scale"], dtype=torch.float32,
                                    device=dev),
            unskipped=torch.tensor(d["unskipped"], dtype=torch.int32,
                                   device=dev),
            overflows=torch.tensor(d.get("overflows", 0), dtype=torch.int32,
                                   device=dev))


def apply_if_finite(updated_tree: Any, old_tree: Any,
                    found_inf: torch.Tensor) -> Any:
    """Keep ``old_tree``'s leaves where ``found_inf`` (the skipped step
    of the reference's wrapped ``optimizer.step``), as a select."""
    return tree_map(lambda new, old: torch.where(found_inf, old, new),
                    updated_tree, old_tree)

"""Group-synchronized NHWC BatchNorm with the add+ReLU epilogue
(counterpart of ``apex_tpu/contrib/groupbn/batch_norm.py``; reference:
``apex/contrib/groupbn/batch_norm.py :: BatchNorm2d_NHWC``, the MLPerf
ResNet block).

The statistics sync across groups of ``bn_group`` consecutive ranks of
the data axis, not the whole axis: ``parallel_state.axis_group`` with
``axis_index_groups`` gives this rank's subgroup (created on every rank
at first use and cached), and ``layers.batchnorm`` syncs over it. The
residual add and the ReLU run in fp32 on the normalized output, then
one cast to x's dtype.
"""

from typing import Dict, Optional, Tuple

import torch

from apex_tpu_torch.models import layers as L
from apex_tpu_torch.transformer import parallel_state as ps
from apex_tpu_torch.utils.platform import DeviceLike


class BatchNorm2d_NHWC:
    """``init() -> (params, running_state)``; ``apply(params, state, x,
    z=None, train=...) -> (y, new_state)``. ``bn_group=0`` syncs across
    the whole axis; ``bn_group=1`` is rank-local (the reference
    default); ``k > 1`` syncs consecutive groups of k ranks. ``momentum``
    is torch's update fraction (default 0.1); ``layers.batchnorm`` gets
    the keep fraction."""

    def __init__(self, num_features: int, *, fuse_relu: bool = False,
                 bn_group: int = 1, momentum: float = 0.1,
                 eps: float = 1e-5,
                 axis_name: Optional[str] = None):
        self.num_features = num_features
        self.fuse_relu = fuse_relu
        self.bn_group = bn_group
        self.momentum = momentum
        self.eps = eps
        self.axis_name = axis_name if axis_name is not None else \
            ps.DATA_AXIS

    def init(self, device: DeviceLike = None) -> Tuple[Dict, Dict]:
        return L.init_batchnorm(self.num_features, device)

    def _groups(self):
        """The axis's index groups, or None for the whole axis."""
        n = ps.get_mesh().shape[self.axis_name]
        k = n if self.bn_group == 0 else self.bn_group
        if n % k:
            raise ValueError(
                f"bn_group {k} does not divide axis size {n}")
        return None if k == n else [list(range(g * k, (g + 1) * k))
                                    for g in range(n // k)]

    def apply(self, params: Dict, state: Dict, x: torch.Tensor,
              z: Optional[torch.Tensor] = None, *, train: bool = True
              ) -> Tuple[torch.Tensor, Dict]:
        sync = self.bn_group != 1 and train   # bn_group 1: rank-local
        group = ps.axis_group(self.axis_name, self._groups())[0] \
            if sync else None
        y, new_state = L.batchnorm(
            params, state, x, train=train, momentum=1.0 - self.momentum,
            eps=self.eps, axis_name=group)
        if z is not None or self.fuse_relu:
            y32 = y.float()
            if z is not None:
                y32 = y32 + z.float()
            if self.fuse_relu:
                y32 = torch.relu(y32)
            y = y32.to(x.dtype)
        return y, new_state

    __call__ = apply

"""SyncBatchNorm — cross-rank batch normalization on ``torch.distributed``
(counterpart of ``apex_tpu/parallel/sync_batchnorm.py``; reference:
``apex/parallel/sync_batchnorm.py`` and ``optimized_sync_batchnorm*``).

Each rank's E[x] and E[x^2] are averaged over the process group in one
all-reduce (``layers.batchnorm(axis_name=group)``, the mesh axis
resolved into its group here), then every rank normalizes with the
group's statistics. A group of one rank is plain BatchNorm.
"""

from typing import Dict, Optional, Tuple

import torch

from apex_tpu_torch.models import layers as L
from apex_tpu_torch.transformer import parallel_state as ps
from apex_tpu_torch.utils.platform import DeviceLike


class SyncBatchNorm:
    """Module-shaped functional SyncBN (channel-last by default).

    ``process_group`` of the reference becomes ``axis_name``: a mesh
    axis of ``parallel_state`` (``data`` by default) or a
    ``ProcessGroup``. ``init() -> (params, running_state)``;
    ``apply(params, state, x, train=...) -> (y, new_state)``."""

    def __init__(self, num_features: int, eps: float = 1e-5,
                 momentum: float = 0.1, affine: bool = True,
                 track_running_stats: bool = True,
                 axis_name: Optional[str] = None,
                 channel_last: bool = True):
        # ``momentum`` follows the torch/apex convention (the UPDATE
        # fraction); layers.batchnorm takes the keep fraction
        self.num_features = num_features
        self.eps = eps
        self.momentum = momentum
        self.affine = affine
        self.track_running_stats = track_running_stats
        self.channel_last = channel_last
        self.axis_name = axis_name if axis_name is not None else ps.DATA_AXIS

    def init(self, device: DeviceLike = None
             ) -> Tuple[Optional[Dict], Optional[Dict]]:
        """(params, running_state); ``affine=False`` gives params None,
        ``track_running_stats=False`` state None (batch statistics in
        eval too: torch's semantics)."""
        params, state = L.init_batchnorm(self.num_features, device)
        return (params if self.affine else None,
                state if self.track_running_stats else None)

    def apply(self, params: Optional[Dict], state: Optional[Dict],
              x: torch.Tensor, *, train: bool = True
              ) -> Tuple[torch.Tensor, Optional[Dict]]:
        if not self.channel_last:
            x = torch.movedim(x, 1, -1)        # NC... -> N...C
        # batch statistics in eval (no running stats) sync too: every
        # replica normalizes alike
        use_batch = train or state is None
        group = ps.axis_group(self.axis_name)[0] if use_batch else None
        y, new_state = L.batchnorm(
            params, state, x, train=train, momentum=1.0 - self.momentum,
            eps=self.eps, axis_name=group)
        if not self.channel_last:
            y = torch.movedim(y, -1, 1)
        return y, new_state

    __call__ = apply


def convert_syncbn_model(apply_fn, axis_name: Optional[str] = None,
                         **partial_kwargs):
    """The reference walks a module tree replacing BatchNorm with
    SyncBatchNorm; the model zoo's apply functions thread an
    ``axis_name`` into every BatchNorm, so conversion binds it: the mesh
    axis (``data`` by default) is resolved into this rank's group at
    each call, so the mesh may come up after the conversion::

        sync_apply = convert_syncbn_model(apply_resnet)
        logits, stats = sync_apply(params, stats, x, depth, train=True)
    """
    axis = axis_name or ps.DATA_AXIS

    def sync_apply(*args, **kwargs):
        group, _ = ps.axis_group(axis)
        return apply_fn(*args, axis_name=group,
                        **{**partial_kwargs, **kwargs})

    return sync_apply

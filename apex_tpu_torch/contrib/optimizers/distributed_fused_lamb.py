"""ZeRO distributed LAMB: the split state with per-tensor trust ratios
(counterpart of ``apex_tpu/contrib/optimizers/distributed_fused_lamb.py``;
reference: ``apex/contrib/optimizers/distributed_fused_lamb.py ::
DistributedFusedLAMB``).

The rows are split over the data ranks as ``DistributedFusedAdam``'s.
What LAMB adds are reductions across the split, as in the JAX package:

- the GLOBAL gradient norm for clipping: the local sum of squares,
  all-reduced;
- each TENSOR's ``||p||`` and ``||u||`` for its trust ratio, a tensor's
  rows possibly on several ranks: the flat layout's per-row tensor ids
  make it a segment sum over the local rows (``index_add_``), then one
  all-reduce of the (num_tensors,) vectors. The tile alignment keeps the
  pad lanes zero, so the sums need no mask.

The update is plain PyTorch, as it is plain ``jnp`` in the JAX package.
"""

from typing import Any, NamedTuple, Optional, Tuple

import torch

from apex_tpu_torch.contrib.optimizers.distributed_fused_adam import (
    _any_found_inf, _data_axis, _gather_rows, _layout,
    _reduce_scatter_rows,
)
from apex_tpu_torch.multi_tensor_apply import flatten as _flatten
from apex_tpu_torch.optimizers._common import (
    check_m_dtype, f32, select_finite,
)
from apex_tpu_torch.transformer import parallel_state as ps
from apex_tpu_torch.transformer.tensor_parallel.mappings import collective
from apex_tpu_torch.utils.tree import tree_flatten, tree_unflatten


class DistributedLambState(NamedTuple):
    step: torch.Tensor
    master: torch.Tensor
    m: torch.Tensor      # fp32 or bf16 (``m_dtype``)
    v: torch.Tensor


class DistributedFusedLAMB:
    """Construct OUTSIDE shard_map; ``step`` INSIDE (the data axis)."""

    def __init__(self, lr: float = 1e-3, bias_correction: bool = True,
                 betas: Tuple[float, float] = (0.9, 0.999),
                 eps: float = 1e-6, weight_decay: float = 0.01,
                 adam_w_mode: bool = True, grad_averaging: bool = True,
                 max_grad_norm: float = 1.0, use_nvlamb: bool = False, *,
                 average_grads: bool = True,
                 dp_size: Optional[int] = None,
                 axis_name: str = ps.DATA_AXIS,
                 m_dtype=torch.float32):
        self.lr = lr
        self.m_dtype = check_m_dtype(m_dtype)
        self.bias_correction = bias_correction
        self.beta1, self.beta2 = betas
        self.eps = eps
        self.weight_decay = weight_decay
        self.adam_w_mode = adam_w_mode
        self.grad_averaging = grad_averaging
        self.max_grad_norm = max_grad_norm
        self.use_nvlamb = use_nvlamb
        self.average_grads = average_grads
        self.axis_name = axis_name
        self.dp = dp_size if dp_size is not None else \
            ps.get_data_parallel_world_size()
        self._specs = {}
        self._row_ids = {}

    def init(self, params: Any) -> DistributedLambState:
        leaves, _, spec = _layout(self._specs, params, self.dp)
        master, _ = _flatten.flatten_tensors(leaves, spec,
                                             dtype=torch.float32)
        return DistributedLambState(
            step=torch.zeros((), dtype=torch.int32, device=master.device),
            master=master, m=torch.zeros(master.shape, dtype=self.m_dtype,
                                         device=master.device),
            v=torch.zeros_like(master))

    def partition_spec(self) -> DistributedLambState:
        P = ps.PartitionSpec
        row = P(self.axis_name, None)
        return DistributedLambState(step=P(), master=row, m=row, v=row)

    def _local_row_ids(self, spec, local_rows, device):
        """The tensor id of each of this rank's rows (the tail padding
        counted to the last tensor; its pad lanes are zero)."""
        key = (spec, device)
        ids = self._row_ids.get(key)
        if ids is None:
            ids = self._row_ids[key] = spec.tile_tensor_ids(
                tile_rows=1).to(device=device, dtype=torch.int64)
        _, _, d = _data_axis(self.axis_name)
        return ids[d * local_rows:(d + 1) * local_rows]

    def _psum(self, x):
        group, members, _ = _data_axis(self.axis_name)
        if len(members) == 1:
            return x
        return collective("all_reduce", x, group, members)

    def step(self, grads: Any, params: Any, state: DistributedLambState,
             *, lr=None, weight_decay=None, grad_scale=1.0,
             found_inf: Optional[torch.Tensor] = None
             ) -> Tuple[Any, DistributedLambState]:
        """ZeRO LAMB step (the rank's own unreduced ``grads``;
        ``grad_scale`` MULTIPLIES, the package's convention)."""
        leaves, treedef, spec = _layout(self._specs, params, self.dp)
        dev = state.master.device
        T = spec.num_tensors
        lr = f32(self.lr if lr is None else lr, dev)
        wd = f32(self.weight_decay if weight_decay is None
                 else weight_decay, dev)
        gs = f32(grad_scale, dev)
        if self.average_grads:
            gs = gs / self.dp
        b1, b2, eps = f32(self.beta1, dev), f32(self.beta2, dev), \
            f32(self.eps, dev)
        t = state.step + 1
        tf = t.to(torch.float32)
        beta3 = 1.0 - b1 if self.grad_averaging else f32(1.0, dev)
        if self.bias_correction:
            c1, c2 = 1.0 - b1 ** tf, 1.0 - b2 ** tf
        else:
            c1 = c2 = f32(1.0, dev)

        gbuf, _ = _flatten.flatten_tensors(tree_flatten(grads)[0], spec)
        g = _reduce_scatter_rows(gbuf, self.axis_name).to(torch.float32) \
            * gs

        # stage 1's preamble: the GLOBAL gradient-norm clip (the shards
        # are disjoint, so the all-reduced local sum is the global one)
        grad_norm = torch.sqrt(self._psum(torch.sum(g * g)))
        max_norm = f32(self.max_grad_norm, dev)
        clip = torch.where((max_norm > 0) & (grad_norm > max_norm),
                           grad_norm / max_norm, f32(1.0, dev))
        g = g / clip

        p32 = state.master
        if not self.adam_w_mode:
            g = g + wd * p32
        m = b1 * state.m.to(torch.float32) + beta3 * g
        v = b2 * state.v + (1.0 - b2) * g * g
        u = (m / c1) / (torch.sqrt(v / c2) + eps)
        if self.adam_w_mode:
            u = u + wd * p32

        # stage 2: per-tensor trust ratios across the split
        ids = self._local_row_ids(spec, g.shape[0], dev)

        def seg_ssq(x):
            return self._psum(torch.zeros(T, device=dev).index_add_(
                0, ids, torch.sum(x * x, dim=1)))

        w_norm, u_norm = torch.sqrt(seg_ssq(p32)), torch.sqrt(seg_ssq(u))
        ratio = torch.where((w_norm > 0) & (u_norm > 0), w_norm / u_norm,
                            f32(1.0, dev))
        if not self.use_nvlamb:
            ratio = torch.where(wd == 0.0, torch.ones_like(ratio), ratio)
        master = p32 - lr * ratio[ids][:, None] * u

        new_state = DistributedLambState(
            step=t, master=master, m=m.to(self.m_dtype), v=v)
        if found_inf is not None:
            found_inf = _any_found_inf(found_inf, self.axis_name, dev)
        new_state = select_finite(found_inf, new_state, state)

        full = _gather_rows(new_state.master, self.axis_name)
        new_params = tree_unflatten(
            treedef, _flatten.unflatten_tensors(full, spec))
        return new_params, new_state

    def state_bytes_per_device(self, params: Any) -> int:
        _, _, spec = _layout(self._specs, params, self.dp)
        per_elem = 4 + 4 + torch.empty((), dtype=self.m_dtype).element_size()
        return per_elem * (spec.total_rows // self.dp) * _flatten.LANES

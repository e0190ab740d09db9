"""ZeRO distributed Adam: the optimizer state split over the data
ranks (counterpart of
``apex_tpu/contrib/optimizers/distributed_fused_adam.py``; reference:
``apex/contrib/optimizers/distributed_fused_adam.py ::
DistributedFusedAdam``).

The unit of the split is a row of the multi-tensor engine's flat
``(R, 128)`` buffer (``multi_tensor_apply.flatten``): data rank d owns
rows ``[d R/dp, (d+1) R/dp)`` of the fp32 master weights and of the two
moments. ``step`` runs inside ``parallel_state.shard_map`` over the
``data`` axis, on this rank's rows (the state passed with
``partition_spec()``): a reduce-scatter of the flat gradients over the
data group, the Adam update on the rank's rows, then an all-gather of
the master rows into the whole params in the model's dtypes. The update
is plain PyTorch, as it is plain ``jnp`` in the JAX package (no Pallas
kernel). ``state.master`` is authoritative; ``params`` gives the
structure and dtypes only.
"""

from typing import Any, NamedTuple, Optional, Tuple

import torch

from apex_tpu_torch.multi_tensor_apply import flatten as _flatten
from apex_tpu_torch.optimizers._common import (
    check_m_dtype, f32, select_finite,
)
from apex_tpu_torch.transformer import parallel_state as ps
from apex_tpu_torch.transformer.tensor_parallel.mappings import collective
from apex_tpu_torch.utils.tree import tree_flatten, tree_unflatten


class DistributedAdamState(NamedTuple):
    step: torch.Tensor   # 0-d int32
    master: torch.Tensor  # (R, 128) fp32: rows split over data at rest
    m: torch.Tensor      # (R, 128) fp32 or bf16 (``m_dtype``)
    v: torch.Tensor      # (R, 128) fp32


def _check_shardable(total_rows: int, dp: int) -> None:
    if total_rows % dp:
        raise ValueError(
            f"flat buffer rows {total_rows} not divisible by data-parallel "
            f"size {dp}; ALIGN_ROWS={_flatten.ALIGN_ROWS} guarantees this "
            "for power-of-two dp <= 256")


def _data_axis(axis_name: str):
    """(group, members, this rank's index) along ``axis_name``."""
    mesh = ps.get_mesh()
    return (mesh.groups[axis_name], mesh.members(axis_name),
            mesh._coords()[ps.MESH_AXIS_NAMES.index(axis_name)])


def _layout(cache: dict, params: Any, dp: int):
    """(leaves in JAX's order, treedef, FlatSpec), the spec cached by the
    leaves' shapes and dtypes and checked shardable once."""
    leaves, treedef = tree_flatten(params)
    key = (repr(treedef), tuple((tuple(x.shape), x.dtype) for x in leaves))
    spec = cache.get(key)
    if spec is None:
        spec = cache[key] = _flatten.make_spec(leaves)
        _check_shardable(spec.total_rows, dp)
    return leaves, treedef, spec


def _reduce_scatter_rows(gbuf, axis_name):
    group, members, _ = _data_axis(axis_name)
    if len(members) == 1:
        return gbuf
    return collective("reduce_scatter", gbuf, group, members, dim=0)


def _gather_rows(rows, axis_name):
    group, members, _ = _data_axis(axis_name)
    if len(members) == 1:
        return rows
    return collective("all_gather", rows, group, members, dim=0)


def _any_found_inf(found_inf, axis_name, device):
    """A rank-local overflow skips the step on EVERY rank: the shards are
    disjoint, so the flags are ORed over the data group first."""
    flag = torch.as_tensor(found_inf, device=device).to(torch.int32)
    group, members, _ = _data_axis(axis_name)
    if len(members) > 1:
        flag = collective("all_reduce", flag, group, members, op="max")
    return flag > 0


class DistributedFusedAdam:
    """Construct OUTSIDE shard_map; call ``step`` INSIDE shard_map over
    the ``data`` axis (the state passed with ``partition_spec()``)."""

    def __init__(self, lr: float = 1e-3, bias_correction: bool = True,
                 betas: Tuple[float, float] = (0.9, 0.999),
                 eps: float = 1e-8, adam_w_mode: bool = True,
                 weight_decay: float = 0.0, *,
                 average_grads: bool = True,
                 dp_size: Optional[int] = None,
                 axis_name: str = ps.DATA_AXIS,
                 m_dtype=torch.float32):
        self.lr = lr
        # a bf16 first moment halves m's share of the state at rest
        # (``state_bytes_per_device``); the update still runs in fp32 and
        # stores round-to-nearest
        self.m_dtype = check_m_dtype(m_dtype)
        self.bias_correction = bias_correction
        self.beta1, self.beta2 = betas
        self.eps = eps
        self.adam_w_mode = adam_w_mode
        self.weight_decay = weight_decay
        self.average_grads = average_grads
        self.axis_name = axis_name
        self.dp = dp_size if dp_size is not None else \
            ps.get_data_parallel_world_size()
        self._specs = {}

    def init(self, params: Any) -> DistributedAdamState:
        leaves, _, spec = _layout(self._specs, params, self.dp)
        master, _ = _flatten.flatten_tensors(leaves, spec,
                                             dtype=torch.float32)
        return DistributedAdamState(
            step=torch.zeros((), dtype=torch.int32, device=master.device),
            master=master, m=torch.zeros(master.shape, dtype=self.m_dtype,
                                         device=master.device),
            v=torch.zeros_like(master))

    def partition_spec(self, *, tensor_axis: Optional[str] = None
                       ) -> DistributedAdamState:
        """The state's specs (shard_map in_specs and out_specs): master,
        m and v split by rows over ``data``. Under dp x tp the flat
        buffers are built from tensor-parallel blocks of the params, so
        each model rank holds other rows: ``tensor_axis`` splits the rows
        over ``(tensor_axis, data)`` jointly, rank ``(t, d)`` owning
        block ``t*dp + d``."""
        P = ps.PartitionSpec
        row = P(self.axis_name, None) if tensor_axis is None \
            else P((tensor_axis, self.axis_name), None)
        return DistributedAdamState(step=P(), master=row, m=row, v=row)

    def step(self, grads: Any, params: Any, state: DistributedAdamState,
             *, lr=None, grad_scale=1.0, weight_decay=None,
             found_inf: Optional[torch.Tensor] = None
             ) -> Tuple[Any, DistributedAdamState]:
        """One ZeRO step on this rank's rows. ``grads`` are the rank's own
        (unreduced: no DDP mean before); the reduce-scatter sums them and
        ``average_grads`` divides by dp. ``grad_scale`` MULTIPLIES (the
        package's convention). Returns (the whole params in the model's
        dtypes, the new state)."""
        leaves, treedef, spec = _layout(self._specs, params, self.dp)
        dev = state.master.device
        lr = f32(self.lr if lr is None else lr, dev)
        wd = f32(self.weight_decay if weight_decay is None
                 else weight_decay, dev)
        gs = f32(grad_scale, dev)
        if self.average_grads:
            gs = gs / self.dp

        gbuf, _ = _flatten.flatten_tensors(tree_flatten(grads)[0], spec)
        # ZeRO collective 1: the sum over the data group, rows scattered
        # in rank order
        g_local = _reduce_scatter_rows(gbuf, self.axis_name)

        t = state.step + 1
        b1, b2, eps = f32(self.beta1, dev), f32(self.beta2, dev), \
            f32(self.eps, dev)
        tf = t.to(torch.float32)
        if self.bias_correction:
            c1, c2 = 1.0 - b1 ** tf, 1.0 - b2 ** tf
        else:
            c1 = c2 = f32(1.0, dev)

        g = g_local.to(torch.float32) * gs
        p32 = state.master
        if not self.adam_w_mode:
            g = g + wd * p32
        m = b1 * state.m.to(torch.float32) + (1.0 - b1) * g
        v = b2 * state.v + (1.0 - b2) * g * g
        u = (m / c1) / (torch.sqrt(v / c2) + eps)
        if self.adam_w_mode:
            u = u + wd * p32
        master = p32 - lr * u

        new_state = DistributedAdamState(
            step=t, master=master, m=m.to(self.m_dtype), v=v)
        if found_inf is not None:
            found_inf = _any_found_inf(found_inf, self.axis_name, dev)
        new_state = select_finite(found_inf, new_state, state)

        # ZeRO collective 2: the updated master rows gathered back
        full = _gather_rows(new_state.master, self.axis_name)
        new_params = tree_unflatten(
            treedef, _flatten.unflatten_tensors(full, spec))
        return new_params, new_state

    def state_bytes_per_device(self, params: Any) -> int:
        """The optimizer state's bytes a device at rest (the ~1/dp
        claim): master and v at 4 bytes each, m at ``m_dtype``'s
        width."""
        _, _, spec = _layout(self._specs, params, self.dp)
        per_elem = 4 + 4 + torch.empty((), dtype=self.m_dtype).element_size()
        return per_elem * (spec.total_rows // self.dp) * _flatten.LANES

"""Data-parallel gradient synchronization on ``torch.distributed``
(counterpart of ``apex_tpu/parallel/distributed.py``; reference:
``apex/parallel/distributed.py :: class DistributedDataParallel``).

The reference hooks every parameter's backward, buckets the gradients,
flattens each bucket and all-reduces it over NCCL on a side stream. The
port's models are functional (gradients come back as a tree), so the
reduction is one call after the backward, :meth:`allreduce_grads`,
with the reference's numerics policy:

- ``allreduce_always_fp32`` — upcast the gradients to fp32 for the
  reduction, and cast the result back;
- ``gradient_average`` — divide by the data-parallel world size;
- ``message_size`` — the most elements a bucket holds: the leaves of one
  reduction dtype are packed, in the JAX package's leaf order, through
  ``multi_tensor_apply.flatten`` into buckets of at most that many
  elements (a larger leaf is a bucket of its own), one all-reduce a
  bucket;
- ``delay_allreduce`` — moot (the reduction already waits for the whole
  backward), accepted for the reference's signature.

Each process holds its own replica, so :meth:`local_replica` is the
identity; :meth:`broadcast_params` gives every rank rank 0's values
exactly (the reference constructor's broadcast). Usage::

    ddp = DistributedDataParallel()
    params = ddp.broadcast_params(params)        # once, before step 1
    x = ddp.shard_batch(global_batch)           # this rank's slice
    grads = ddp.allreduce_grads(grads_of(params, x))
"""

from typing import Any, Optional

import torch
import torch.distributed as dist

from apex_tpu_torch.multi_tensor_apply.flatten import (
    flatten_tensors, unflatten_tensors,
)
from apex_tpu_torch.transformer import parallel_state as ps
from apex_tpu_torch.utils.tree import tree_flatten, tree_unflatten


class DistributedDataParallel:
    def __init__(self, module=None, *, message_size: int = 10_000_000,
                 delay_allreduce: bool = False,
                 allreduce_always_fp32: bool = False,
                 gradient_average: bool = True,
                 axis_name: Optional[str] = None):
        if message_size < 1:
            raise ValueError(f"message_size must be >= 1, got {message_size}")
        self.module = module
        self.message_size = message_size
        self.allreduce_always_fp32 = allreduce_always_fp32
        self.gradient_average = gradient_average
        self.axis_name = axis_name if axis_name is not None else ps.DATA_AXIS

    def local_replica(self, params: Any) -> Any:
        """Each process already holds its own replica: the identity."""
        return params

    def _buckets(self, leaves):
        """Lists of leaf indices: leaves of one reduction dtype, in order,
        at most ``message_size`` elements a bucket."""
        out, open_ = [], {}
        for i, g in enumerate(leaves):
            dt = torch.float32 if self.allreduce_always_fp32 else g.dtype
            b = open_.get(dt)
            if b is None or b[1] + g.numel() > self.message_size:
                b = open_[dt] = [[], 0, dt]
                out.append(b)
            b[0].append(i)
            b[1] += g.numel()
        return [(idx, dt) for idx, _, dt in out]

    def allreduce_grads(self, grads: Any) -> Any:
        """Sum the gradients over the data group (optionally in fp32),
        divide by its size when ``gradient_average``, and cast back to
        each leaf's dtype: the JAX ``psum`` / ``psum(1)`` in its order of
        operations, one all-reduce a bucket."""
        group, size = ps.axis_group(self.axis_name)
        leaves, treedef = tree_flatten(grads)
        out = list(leaves)
        for idx, dt in self._buckets(leaves):
            buf, spec = flatten_tensors([leaves[i] for i in idx], dtype=dt)
            dist.all_reduce(buf, group=group)
            if self.gradient_average:
                buf.div_(size)
            for i, t in zip(idx, unflatten_tensors(buf, spec)):
                out[i] = t
        return tree_unflatten(treedef, out)

    def broadcast_params(self, params: Any) -> Any:
        """Every data-parallel rank gets the values of the group's rank 0
        exactly, in each leaf's own dtype (bool and wide ints too): the
        leaves' bytes packed in one buffer (each leaf at a 16-byte
        offset) and broadcast from the group's first rank."""
        group, _ = ps.axis_group(self.axis_name)
        src = ps.get_mesh().members(self.axis_name)[0] \
            if isinstance(self.axis_name, str) \
            else dist.get_global_rank(group, 0)
        leaves, treedef = tree_flatten(params)
        if not leaves:
            return params
        sizes = [t.numel() * t.element_size() for t in leaves]
        starts = [0]
        for n in sizes:
            starts.append(starts[-1] + -(-n // 16) * 16)
        raw = torch.zeros(starts[-1], dtype=torch.uint8,
                          device=leaves[0].device)
        for t, at, n in zip(leaves, starts, sizes):
            raw[at:at + n] = t.detach().contiguous().reshape(-1).view(
                torch.uint8)
        dist.broadcast(raw, src=src, group=group)
        return tree_unflatten(treedef, [
            raw[at:at + n].view(t.dtype).reshape(t.shape).clone()
            for t, at, n in zip(leaves, starts, sizes)])

    def shard_batch(self, batch: Any, mesh=None) -> Any:
        """This rank's slice of a global batch: every leaf's leading
        dimension split over the data axis, by data rank."""
        return ps.shard_map(lambda b: b, mesh=mesh,
                            in_specs=ps.PartitionSpec(ps.DATA_AXIS),
                            out_specs=ps.PartitionSpec())(batch)

    def replicate(self, tree: Any, mesh=None) -> Any:
        """Every process holds its own copy already: the identity."""
        return tree

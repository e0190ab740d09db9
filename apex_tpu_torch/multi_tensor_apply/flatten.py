"""Flat-buffer layout for the multi-tensor kernels (counterpart of
``apex_tpu/multi_tensor_apply/flatten.py``), kept exactly: tensors are
packed into ONE zero-padded ``(rows, 128)`` buffer, each tensor's span
rounded up to whole ``(8, 128)`` tiles and the whole buffer to
``ALIGN_ROWS`` rows. A flat optimizer state therefore has the JAX
package's layout buffer for buffer.

Trees are flattened in JAX's leaf order (dict keys sorted,
``utils.tree.tree_flatten``), not in the insertion order the port's
``tree_leaves`` visits, so the spans line up with the JAX package's.
"""

import dataclasses
import math
from typing import Any, List, Sequence, Tuple

import torch

from apex_tpu_torch.utils.math import cdiv, round_up_to_multiple
from apex_tpu_torch.utils.platform import DeviceLike, resolve_device
from apex_tpu_torch.utils.tree import tree_flatten, tree_unflatten

LANES = 128
SUBLANES = 8       # each tensor's span: whole (8, 128) tiles
ALIGN_ROWS = 256   # whole-buffer alignment


@dataclasses.dataclass(frozen=True)
class FlatSpec:
    """Static layout of a flat buffer: per-tensor shapes and row spans."""

    shapes: Tuple[Tuple[int, ...], ...]
    dtypes: Tuple[torch.dtype, ...]
    row_offsets: Tuple[int, ...]   # first row of each tensor's span
    row_counts: Tuple[int, ...]    # rows (of 128 lanes) per tensor
    total_rows: int

    @property
    def num_tensors(self) -> int:
        return len(self.shapes)

    def tile_tensor_ids(self, tile_rows: int = SUBLANES) -> torch.Tensor:
        """int32 tensor (CPU) mapping each row-tile to its tensor index;
        the ALIGN_ROWS tail padding goes to the last tensor, as in JAX."""
        ids = torch.full((self.total_rows // tile_rows,),
                         max(self.num_tensors - 1, 0), dtype=torch.int32)
        for t, (off, cnt) in enumerate(zip(self.row_offsets,
                                           self.row_counts)):
            ids[off // tile_rows: (off + cnt) // tile_rows] = t
        return ids


def make_spec(tensors: Sequence[torch.Tensor]) -> FlatSpec:
    shapes, dtypes, offsets, counts = [], [], [], []
    row = 0
    for t in tensors:
        rows = round_up_to_multiple(cdiv(t.numel(), LANES), SUBLANES)
        shapes.append(tuple(t.shape))
        dtypes.append(t.dtype)
        offsets.append(row)
        counts.append(rows)
        row += rows
    return FlatSpec(tuple(shapes), tuple(dtypes), tuple(offsets),
                    tuple(counts), round_up_to_multiple(row, ALIGN_ROWS))


def flatten_tensors(tensors: Sequence[torch.Tensor], spec: FlatSpec = None,
                    dtype: torch.dtype = torch.float32
                    ) -> Tuple[torch.Tensor, FlatSpec]:
    """Pack tensors into a zero-padded ``(rows, 128)`` buffer of
    ``dtype`` on the first tensor's device (one zero fill, then one copy
    a tensor)."""
    if spec is None:
        spec = make_spec(tensors)
    shapes = tuple(tuple(t.shape) for t in tensors)
    if shapes != spec.shapes:
        raise ValueError(f"tensors of shapes {shapes} do not fit a flat "
                         f"layout of {spec.shapes}")
    buf = torch.zeros((spec.total_rows * LANES,), dtype=dtype,
                      device=tensors[0].device)
    for t, off in zip(tensors, spec.row_offsets):
        start = off * LANES
        buf[start:start + t.numel()].copy_(t.reshape(-1))
    return buf.view(spec.total_rows, LANES), spec


def zeros_buffer(spec: FlatSpec, dtype: torch.dtype = torch.float32,
                 device: DeviceLike = None) -> torch.Tensor:
    """A zeroed flat buffer for ``spec`` in ``dtype`` (a bf16 first
    moment beside fp32 master and v buffers of the same layout)."""
    return torch.zeros((spec.total_rows, LANES), dtype=dtype,
                       device=resolve_device(device))


def unflatten_tensors(buf: torch.Tensor, spec: FlatSpec,
                      cast_back: bool = True) -> List[torch.Tensor]:
    """Views of ``buf`` in the tensors' shapes (cast to their dtypes with
    ``cast_back``; a view still where the dtype already matches)."""
    flat = buf.reshape(-1)
    out = []
    for shape, dt, off in zip(spec.shapes, spec.dtypes, spec.row_offsets):
        t = flat[off * LANES: off * LANES + math.prod(shape)].view(shape)
        out.append(t.to(dt) if cast_back else t)
    return out


def flatten_pytree(tree: Any, dtype: torch.dtype = torch.float32
                   ) -> Tuple[torch.Tensor, FlatSpec, Any]:
    """Tree front-end: returns ``(buffer, spec, treedef)``, the leaves in
    JAX's order."""
    leaves, treedef = tree_flatten(tree)
    buf, spec = flatten_tensors(leaves, dtype=dtype)
    return buf, spec, treedef


def unflatten_pytree(buf: torch.Tensor, spec: FlatSpec, treedef: Any,
                     cast_back: bool = True) -> Any:
    return tree_unflatten(treedef, unflatten_tensors(buf, spec, cast_back))

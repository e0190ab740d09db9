"""1-D halo exchange for spatially sharded tensors (counterpart of
``apex_tpu/contrib/peer_memory/halo_exchange.py``; reference:
``apex/contrib/peer_memory/peer_halo_exchanger_1d.py``).

An image's H dimension is split over the ranks of the ``context`` axis,
and a convolution needs ``halo`` rows from each neighbour. The JAX
package moves them with two ``lax.ppermute``s; here each is a ring
shift over this rank's ``context`` group
(``tensor_parallel.mappings.shift``: one ``isend`` and one ``irecv``,
both waited on): this rank's bottom rows go one place on (``step=+1``)
and its top rows one place back (``step=-1``). A CUDA tensor on a gloo
group is staged through the host (``mappings.staged_bytes``).

The shift is a ``torch.autograd.Function`` whose backward shifts the
halo's gradient back the other way; the slices' backward adds it into
the sender's boundary rows, so each row's gradient returns to the rank
that owns it, as JAX's transpose of the permute returns it. Non-periodic
edges are zero-filled (SAME padding at the outer boundary) by a select
that keeps the received halo in the graph: every rank posts the
backward shift, and the edge's gradient is zero.
"""

from typing import Optional

import torch

from apex_tpu_torch.transformer import parallel_state as ps
from apex_tpu_torch.transformer.tensor_parallel.mappings import shift


def halo_exchange_1d(x: torch.Tensor, halo: int, *, axis: int = 1,
                     axis_name: str = ps.CONTEXT_AXIS,
                     periodic: bool = False) -> torch.Tensor:
    """Concatenate the neighbours' boundary slices onto this rank's
    shard: ``[prev rank's last halo | x | next rank's first halo]``
    along ``axis`` (``2 * halo + x.shape[axis]``). ``periodic`` wraps
    around the ring instead of zero-filling the edges."""
    mesh = ps.get_mesh()
    n = len(mesh.members(axis_name))
    rank = mesh._coords()[ps.MESH_AXIS_NAMES.index(axis_name)]
    if halo <= 0:
        raise ValueError(f"halo must be positive, got {halo}")
    if halo > x.shape[axis]:
        raise ValueError(
            f"halo {halo} exceeds local extent {x.shape[axis]}")
    size = x.shape[axis]
    bottom = x.narrow(axis, size - halo, halo)
    top = x.narrow(axis, 0, halo)
    from_prev = shift(bottom, axis_name, 1)    # prev's bottom
    from_next = shift(top, axis_name, -1)      # next's top
    if not periodic:
        # the first rank has no prev, the last no next: zeros
        zero = torch.zeros((), dtype=x.dtype, device=x.device)
        if rank == 0:
            from_prev = torch.where(torch.tensor(True, device=x.device),
                                    zero, from_prev)
        if rank == n - 1:
            from_next = torch.where(torch.tensor(True, device=x.device),
                                    zero, from_next)
    return torch.cat([from_prev, x, from_next], dim=axis)


class PeerHaloExchanger1d:
    """The reference's constructor shape (``peer_ranks`` becomes the mesh
    axis; the reference's ``peer_pool`` of peer-mapped buffers has no
    counterpart: the collectives' buffers are torch.distributed's)."""

    def __init__(self, axis_name: str = ps.CONTEXT_AXIS,
                 halo: int = 1, *, axis: int = 1,
                 periodic: bool = False):
        self.axis_name = axis_name
        self.halo = halo
        self.axis = axis
        self.periodic = periodic

    def __call__(self, x: torch.Tensor,
                 halo: Optional[int] = None) -> torch.Tensor:
        return halo_exchange_1d(
            x, halo if halo is not None else self.halo, axis=self.axis,
            axis_name=self.axis_name, periodic=self.periodic)

"""dp x tp x pp x cp mesh factory over ``parallel_state`` (counterpart
of ``apex_tpu/partition/mesh.py``): callers name the parallel degrees and
the factory installs the mesh through
:func:`parallel_state.initialize_model_parallel`, which owns the axis
names and the rank layout. An explicit ``dp`` is checked against the
world, so ``make_mesh(dp=4, tp=2)`` on another world size fails."""

from typing import Optional, Sequence

import torch.distributed as dist

from apex_tpu_torch.transformer import parallel_state as ps
from apex_tpu_torch.utils.platform import DeviceLike


def make_mesh(dp: int = 1, tp: int = 1, pp: int = 1, cp: int = 1, *,
              devices: Optional[Sequence[int]] = None,
              device: DeviceLike = None) -> ps.Mesh:
    """Build and install the ``(data, pipe, context, model)`` mesh for
    the given degrees over the first ``dp*tp*pp*cp`` ranks of the default
    process group, or over ``devices`` (global ranks, all of them used).
    ``device`` brings up the process group where none exists
    (``initialize_model_parallel``'s). Returns the mesh."""
    for name, n in (("dp", dp), ("tp", tp), ("pp", pp), ("cp", cp)):
        if int(n) < 1:
            raise ValueError(f"{name} must be a positive integer, got {n}")
    need = int(dp) * int(tp) * int(pp) * int(cp)
    if devices is None:
        ps._bring_up(device)
        world = dist.get_world_size()
        if need > world:
            raise ValueError(
                f"mesh dp{dp} x tp{tp} x pp{pp} x cp{cp} needs {need} "
                f"devices, have {world}")
        devices = list(range(need))
    elif len(devices) != need:
        raise ValueError(
            f"mesh dp{dp} x tp{tp} x pp{pp} x cp{cp} needs exactly "
            f"{need} devices, got {len(devices)}")
    return ps.initialize_model_parallel(
        tensor_model_parallel_size_=int(tp),
        pipeline_model_parallel_size_=int(pp),
        context_parallel_size_=int(cp),
        data_parallel_size_=int(dp),
        devices=devices, device=device)

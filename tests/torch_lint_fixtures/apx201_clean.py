# apxlint: fixture
# Known-clean APX201 twin: rank-dependent compute around one collective
# sequence, a config branch (the same on every rank), and a
# point-to-point exchange whose send and receive sit in the two
# branches of one rank split on one group.
import torch.distributed as dist

from apex_tpu_torch.transformer import parallel_state as ps
from apex_tpu_torch.transformer.tensor_parallel.mappings import (
    collective,
    shift,
)


def uniform_reduce(x, group, members):
    if dist.get_rank() == 0:
        x = x * 2.0
    return collective("all_reduce", x, group, members)


def config_gather(x, group, members, n):
    if n > 1:
        x = collective("all_gather", x, group, members)
    return x


def both_stages_shift(x):
    if ps.get_pipeline_model_parallel_rank() == 0:
        x = shift(x, ps.PIPE_AXIS, 1)
    else:
        x = shift(x + 1.0, ps.PIPE_AXIS, 1)
    return x


def handoff(t, src, dst, group):
    rank = dist.get_rank()
    if rank == src:
        dist.send(t, dst, group=group)
    elif rank == dst:
        dist.recv(t, src, group=group)
    return t

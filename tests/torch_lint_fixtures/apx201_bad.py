# apxlint: fixture
# Known-bad APX201: collectives only some ranks reach, a reordered pair
# on two pipeline stages, and a send with no receiving branch. Each
# rank-dependent split must raise APX201.
import torch.distributed as dist

from apex_tpu_torch.transformer import parallel_state as ps
from apex_tpu_torch.transformer.tensor_parallel.mappings import collective


def rank_divergent_reduce(x, group, members):
    if dist.get_rank() == 0:
        x = collective("all_reduce", x, group, members)
    return x


def stage_reordered(x, y, group):
    if ps.is_pipeline_first_stage():
        dist.all_reduce(x, group=group)
        dist.broadcast(y, src=0, group=group)
    else:
        dist.broadcast(y, src=0, group=group)
        dist.all_reduce(x, group=group)
    return x, y


def one_sided_send(t, group):
    if dist.get_rank() == 0:
        dist.send(t, 1, group=group)
    return t

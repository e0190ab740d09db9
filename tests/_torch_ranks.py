"""Gloo ranks for the port's multi-rank CPU tests: ``spawn(job, world,
tmp)`` runs ``job(rank, world, tmp)`` (a function at the top of a test
module) in ``world`` processes spawned with ``torch.multiprocessing``,
one thread each, meeting through a file in ``tmp`` (no TCP port, so
parallel test workers cannot clash), and returns each rank's result.
The ranks import the test module again, so it imports no JAX at its
top."""

import datetime
import os
import time

import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

GROUP_TIMEOUT_S = 120


def _rank_main(rank, world, tmp, job):
    from apex_tpu_torch.transformer import parallel_state as ps

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{os.path.join(tmp, 'pg')}", rank=rank,
        world_size=world,
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    try:
        out = job(rank, world, tmp)
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        ps.destroy_model_parallel()
        dist.destroy_process_group()


def spawn(job, world, tmp, timeout=300):
    """Run ``job`` in ``world`` gloo ranks; each rank's result, in rank
    order. Fails (and ends the ranks) past ``timeout`` seconds."""
    ctx = mp.spawn(_rank_main, args=(world, str(tmp), job), nprocs=world,
                   join=False)
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.terminate()
            pytest.fail(f"{job.__name__}: ranks did not finish in "
                        f"{timeout} s")
    return [torch.load(os.path.join(str(tmp), f"rank{r}.pt"))
            for r in range(world)]

"""Gloo ranks for the port's multi-rank CPU tests: ``spawn(job, world,
tmp)`` runs ``job(rank, world, tmp)`` (a function at the top of a test
module) in ``world`` processes spawned with ``torch.multiprocessing``,
one thread each, meeting through a file in ``tmp`` (no TCP port, so
parallel test workers cannot clash), and returns each rank's result.
The ranks import the test module again, so it imports no JAX at its
top.

A rank that has saved its result waits at a barrier before the groups
go: no rank tears its process groups down while a peer may still be
inside its last collective (a gloo pair torn down under a peer's
pending exchange aborts the process). A rank that dies fails the test
with the job's name, the rank and its exit signal or code."""

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
        dist.barrier()
    finally:
        ps.destroy_model_parallel()
        dist.destroy_process_group()


def _end(ctx):
    for p in ctx.processes:
        if p.is_alive():
            p.terminate()


def spawn(job, world, tmp, timeout=300):
    """Run ``job`` in ``world`` gloo ranks; each rank's result, in rank
    order. Fails (and ends the ranks) past ``timeout`` seconds."""
    ctx = mp.spawn(_rank_main, args=(world, str(tmp), job), nprocs=world,
                   join=False)
    deadline = time.monotonic() + timeout
    while True:
        try:
            if ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
                break
        except mp.ProcessExitedException as e:
            _end(ctx)
            how = f"signal {e.signal_name}" if e.signal_name \
                else f"exit code {e.exit_code}"
            pytest.fail(f"{job.__name__}: rank {e.error_index} of {world} "
                        f"died ({how})")
        except mp.ProcessRaisedException as e:
            _end(ctx)
            pytest.fail(f"{job.__name__}: rank {e.error_index} of {world} "
                        f"raised:\n{e}")
        if time.monotonic() > deadline:
            _end(ctx)
            pytest.fail(f"{job.__name__}: ranks did not finish in "
                        f"{timeout} s")
    return [torch.load(os.path.join(str(tmp), f"rank{r}.pt"))
            for r in range(world)]

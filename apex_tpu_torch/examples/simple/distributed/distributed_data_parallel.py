#!/usr/bin/env python
"""Minimal DDP example, the port of
``examples/simple/distributed/distributed_data_parallel.py`` (the
reference's acceptance script: a linear model trained under
``apex.parallel.DistributedDataParallel`` + ``amp.initialize``): the
same 4096 -> 2048 -> 16 model, amp with a dynamic loss scale,
``FusedSGD``, weights and data from ``--seed`` through ``utils.prng``
(``jax.random``'s streams), the global batch drawn on every rank and
sliced by data rank.

One process a rank. The world comes from the process group:
``parallel_state.initialize_model_parallel`` brings it up from a
launcher's environment, or as a world of one::

    torchrun --nproc_per_node 2 -m \\
        apex_tpu_torch.examples.simple.distributed.distributed_data_parallel
    python -m apex_tpu_torch.examples.simple.distributed.distributed_data_parallel

``DistributedDataParallel.broadcast_params`` gives every rank rank 0's
weights once, before the first step, as the reference's constructor
does. (The JAX script broadcasts inside every step only because its
step is one SPMD program; after the first step the replicas are already
equal, so the numbers are the same.) Each rank takes ``found_inf`` from
its own gradients, before the all-reduce, as the reference does. The
printed loss is the mean over the data ranks.
"""

import argparse

import torch
import torch.distributed as dist

from apex_tpu_torch import amp
from apex_tpu_torch.optimizers import FusedSGD
from apex_tpu_torch.parallel import DistributedDataParallel
from apex_tpu_torch.transformer import parallel_state as ps
from apex_tpu_torch.utils import prng
from apex_tpu_torch.utils.platform import DeviceLike, resolve_device


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--dp", type=int, default=0,
                   help="data-parallel degree (0: the process group's "
                   "world; another value must equal it)")
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("-b", "--batch-size", type=int, default=64,
                   help="GLOBAL batch size")
    p.add_argument("--lr", type=float, default=0.1)
    p.add_argument("--opt-level", default="O2",
                   choices=["O0", "O1", "O2", "O3"])
    p.add_argument("--seed", type=int, default=0)
    return p.parse_args(argv)


def loss_fn(p, x, y):
    h1 = torch.relu(x @ p["fc1"]["w"] + p["fc1"]["b"])
    out = h1 @ p["fc2"]["w"] + p["fc2"]["b"]
    return torch.mean((out.float() - y) ** 2)


def train(args, device: DeviceLike = None):
    """The script's run; returns (master params, printed losses by
    step)."""
    ps.initialize_model_parallel(device=device)
    dev = resolve_device(device)
    dp = ps.get_data_parallel_world_size()
    if args.dp and args.dp != dp:
        raise ValueError(f"--dp {args.dp}, but the process group's data "
                         f"axis holds {dp} ranks")
    ddp = DistributedDataParallel()
    group, _ = ps.axis_group(ps.DATA_AXIS)
    h = amp.initialize(opt_level=args.opt_level, loss_scale="dynamic")

    k1, k2, _ = prng.split(prng.PRNGKey(args.seed), 3)
    master = {
        "fc1": {"w": prng.normal(k1, (4096, 2048), device=dev) * 0.01,
                "b": torch.zeros((2048,), device=dev)},
        "fc2": {"w": prng.normal(k2, (2048, 16), device=dev) * 0.01,
                "b": torch.zeros((16,), device=dev)},
    }
    master = ddp.broadcast_params(master)
    opt = FusedSGD(lr=args.lr)
    opt_state = opt.init(master)
    scaler_state = h.init_state(dev)
    value_and_grad = h.value_and_grad(
        lambda p, x, y: loss_fn(p, h.cast_input(x), y))

    losses = {}
    for i in range(args.steps):
        k = prng.PRNGKey(100 + i)
        x, y = ddp.shard_batch(
            (prng.normal(k, (args.batch_size, 4096), device=dev),
             prng.normal(k, (args.batch_size, 16), device=dev)))
        loss, grads, found_inf, scaler_state = value_and_grad(
            h.cast_model(master), scaler_state, x, y)
        grads = ddp.allreduce_grads(grads)   # the DDP hook: mean over dp
        master, opt_state = opt.step(grads, master, opt_state,
                                     found_inf=found_inf)
        loss = loss.detach().clone()
        dist.all_reduce(loss, group=group)
        loss = float(loss) / dp
        if i % 5 == 0 or i == args.steps - 1:
            losses[i] = loss
            if dist.get_rank() == 0:
                print(f"step {i:3d}  dp {dp}  loss {loss:.6f}", flush=True)
    if dist.get_rank() == 0:
        print("DONE", flush=True)
    return master, losses


def main(argv=None, device: DeviceLike = None):
    train(parse_args(argv), device)


if __name__ == "__main__":
    main()

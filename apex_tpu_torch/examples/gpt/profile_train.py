"""Where the GPT-medium training step's time goes, on the CUDA device:
``examples/gpt/train.py``'s step (the JAX package's ``gpt_tp_bench``
tp=1 step: bf16 compute over fp32 params, per-layer remat, FusedAdam)
with random weights from seed 0, batch 8, seq 1024, one fixed batch,
after two warm-up steps.

It prints, from host clocks around work that ends in a device
synchronise, the median time of the gradient half (``GPTTrainStep
.grads``) and of the optimizer step over 3 steps; then one step under
``torch.profiler``: its wall time (profiler on), the summed device time
of the kernels and copies, their share of the wall, the device time by
group (this package's kernels, matrix products, everything else), RoPE's
device time and kernel count (the angle table, the rotation of q and k,
its recompute and its backward) and the top entries. Last, one JSON
line with the same numbers::

    python -m apex_tpu_torch.examples.gpt.profile_train
    python -m apex_tpu_torch.examples.gpt.profile_train --use-rope \\
        --dropout-seed 0 --flat-kernel

The flags are ``examples/gpt/train.py``'s.
"""

import argparse
import dataclasses
import json
import statistics
import time

import torch

from apex_tpu_torch.examples.bert.profile_train import group
from apex_tpu_torch.examples.gpt.profile_serving import rope_marked, window
from apex_tpu_torch.examples.gpt.train import (
    make_gpt_train_step, make_state, synthetic_batch,
)
from apex_tpu_torch.models.gpt import gpt_medium
from apex_tpu_torch.optimizers import FusedAdam
from apex_tpu_torch.utils import prng
from apex_tpu_torch.utils.platform import resolve_device


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=1024)
    p.add_argument("--use-rope", action="store_true")
    p.add_argument("--dropout-seed", type=int, default=None)
    p.add_argument("--flat-kernel", action="store_true")
    p.add_argument("--no-remat", action="store_true")
    args = p.parse_args(argv)
    dev = resolve_device(None)
    cfg = dataclasses.replace(gpt_medium(), use_rope=args.use_rope,
                              remat=not args.no_remat)
    key = None if args.dropout_seed is None else prng.PRNGKey(
        args.dropout_seed)
    step = make_gpt_train_step(
        cfg, FusedAdam(lr=1e-4, weight_decay=0.01,
                       use_flat_kernel=args.flat_kernel), dropout_rng=key)
    params, opt_state = make_state(cfg, step.opt, 0, dev)
    ids = synthetic_batch(0, args.batch, args.seq, cfg.vocab_size, dev)
    for _ in range(2):
        params, opt_state, _ = step(params, opt_state, ids, ids)
    t_grads, t_opt = [], []
    for i in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, grads = step.grads(params, ids, ids, dropout_rng=None if key is
                              None else prng.fold_in(key, i))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        params, opt_state = step.opt.step(grads, params, opt_state)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        t_grads.append((t1 - t0) * 1e3)
        t_opt.append((t2 - t1) * 1e3)
        del grads
    res = {"grads_ms": statistics.median(t_grads),
           "optimizer_ms": statistics.median(t_opt)}
    print(f"gradient half {res['grads_ms']:.1f} ms, FusedAdam "
          f"({'flat' if args.flat_kernel else 'tree'}) step "
          f"{res['optimizer_ms']:.1f} ms (medians of 3, host clock around "
          "synchronised work)")

    def one_step():
        nonlocal params, opt_state
        params, opt_state, _ = step(params, opt_state, ids, ids)

    with rope_marked():
        res.update(window("one step", one_step, groups=group, n_top=12,
                          rope=args.use_rope))
    res.update(vars(args))
    print(json.dumps(res))


if __name__ == "__main__":
    main()

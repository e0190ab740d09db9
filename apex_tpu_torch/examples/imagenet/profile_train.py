"""Where the ResNet-50 training step's time goes, on the CUDA device:
``make_resnet_train_step`` with random weights from seed 0, batch 64,
224 x 224, on one fixed synthetic batch, in each configuration of
``main_amp.CONFIGS`` (``resnet_tree_o0``, ``resnet_flat_o0``,
``resnet_flat_o2``), after two warm-up steps.

For each configuration it prints, from host clocks around work that ends
in a device synchronise, the median time of the gradient half of the
step (casts, forward, backward, unscale; ``ResNetTrainStep.grads``) and
of the optimizer step with the statistics' skip select, over 3 steps;
then one step under ``torch.profiler``: its wall time (profiler on), the
summed device time of the kernels and copies the profiler saw, their
share of the wall, the device time by group (this package's kernels,
matrix products and convolutions' GEMMs, everything else) and the top
entries. Last, one JSON line with the same numbers::

    python -m apex_tpu_torch.examples.imagenet.profile_train
"""

import argparse
import json
import statistics
import time

import torch

from apex_tpu_torch import amp
from apex_tpu_torch.examples.bert.profile_train import group
from apex_tpu_torch.examples.gpt.profile_serving import window
from apex_tpu_torch.examples.imagenet.main_amp import (
    CONFIGS, LR, MOMENTUM, WEIGHT_DECAY, make_resnet_train_step,
    synthetic_batch,
)
from apex_tpu_torch.models.resnet import init_resnet
from apex_tpu_torch.optimizers import FusedSGD
from apex_tpu_torch.utils.platform import resolve_device

DEPTH, CLASSES, BATCH, SIZE = 50, 1000, 64, 224


def main(argv=None):
    argparse.ArgumentParser(description=__doc__.split("\n")[0]).parse_args(
        argv)
    dev = resolve_device(None)
    images, labels = synthetic_batch(0, BATCH, SIZE, CLASSES, dev)
    res = {}
    for name, (level, flat) in CONFIGS.items():
        step = make_resnet_train_step(DEPTH, level, optimizer=FusedSGD(
            lr=LR, momentum=MOMENTUM, weight_decay=WEIGHT_DECAY,
            use_flat_kernel=flat))
        params, stats = init_resnet(
            torch.Generator(device=dev).manual_seed(0), DEPTH, CLASSES,
            device=dev)
        state = list(step.init_state(params, stats, dev))
        del params, stats
        for _ in range(2):
            *state, _ = step(*state, images, labels)
        t_grads, t_opt = [], []
        for _ in range(3):
            master, bn_stats, opt_state, scaler = state
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, new_stats, grads, found, scaler = step.grads(
                master, bn_stats, scaler, images, labels)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            master, opt_state = step.opt.step(grads, master, opt_state,
                                              found_inf=found)
            new_stats = amp.apply_if_finite(new_stats, bn_stats, found)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            state = [master, new_stats, opt_state, scaler]
            t_grads.append((t1 - t0) * 1e3)
            t_opt.append((t2 - t1) * 1e3)
        phases = {"grads_ms": statistics.median(t_grads),
                  "optimizer_ms": statistics.median(t_opt)}
        print(f"{name}: gradient half {phases['grads_ms']:.1f} ms, "
              f"FusedSGD step {phases['optimizer_ms']:.1f} ms (medians of "
              "3, host clock around synchronised work)")

        def one_step():
            nonlocal state
            *state, _ = step(*state, images, labels)

        res[name] = dict(phases, **window(f"{name}: one step", one_step,
                                          groups=group, n_top=12))
        del state, step
        torch.cuda.empty_cache()
    print(json.dumps(res))


if __name__ == "__main__":
    main()

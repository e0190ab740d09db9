"""Where the BERT-Large O2 training step's time goes, on the CUDA device:
random weights from seed 0, batch 64, seq 128, in each optimizer-state
mode (``fp32``, ``bf16m_castout``), after two warm-up steps.

For each mode it prints, from host clocks around work that ends in a
device synchronise, the median time of the gradient half of the step
(cast, forward, backward, unscale; ``BertTrainStep.grads``) and of the
optimizer step, over 3 steps each; then one step under
``torch.profiler``: its wall time (profiler on), the summed device time
of the kernels and copies the profiler saw, their share of the wall,
the device time by group (this package's kernels, matrix products,
everything else) and the top entries. Last, one JSON line with the same
numbers::

    python -m apex_tpu_torch.examples.bert.profile_train
    python -m apex_tpu_torch.examples.bert.profile_train \
        --attention softmax --flat-kernel
    python -m apex_tpu_torch.examples.bert.profile_train \
        --optimizer lamb --flat-kernel

``--attention softmax`` runs the unfused attention (the fused softmax
kernels), ``--optimizer lamb`` FusedLAMB in place of FusedAdam, and
``--flat-kernel`` the optimizer's flat path, as in
``examples/bert/train.py``.
"""

import argparse
import dataclasses
import json
import statistics
import time

import torch

from apex_tpu_torch.examples.bert.train import (
    OPTIMIZERS, STATE_MODES, make_bert_train_step,
)
from apex_tpu_torch.examples.gpt.profile_serving import window
from apex_tpu_torch.models.bert import bert_large
from apex_tpu_torch.utils.platform import resolve_device

BATCH, SEQ = 64, 128
# device-kernel name fragments of this package's kernels
OURS = ("layer_norm_fwd_kernel", "layer_norm_bwd", "flash_fwd_kernel",
        "flash_fwd_tc_kernel", "flash_dq_kernel", "flash_dq_tc_kernel",
        "flash_dkv_kernel", "flash_dkv_tc_kernel", "xent_fwd_kernel",
        "xent_bwd_kernel", "softmax_fwd", "softmax_bwd", "adam_kernel",
        "l2_partials_kernel", "lamb_stage1_kernel", "sgd_kernel",
        "adagrad_kernel", "novograd_kernel")
GEMM = ("gemm", "xmma", "cutlass", "sm90_", "cublas", "nvjet")


def group(kern):
    out = {"ours": 0.0, "matmul": 0.0, "other": 0.0}
    for k, t in kern.items():
        if any(s in k for s in OURS):
            out["ours"] += t
        elif any(s in k.lower() for s in GEMM):
            out["matmul"] += t
        else:
            out["other"] += t
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--attention", choices=("flash", "softmax"),
                   default="flash")
    p.add_argument("--optimizer", choices=sorted(OPTIMIZERS),
                   default="adam")
    p.add_argument("--flat-kernel", action="store_true")
    args = p.parse_args(argv)
    dev = resolve_device(None)
    cfg = dataclasses.replace(bert_large(),
                              fused_attention=args.attention == "flash")
    res = {}
    for mode, (m_dtype, emit) in STATE_MODES.items():
        step, make_state, (ids, mask) = make_bert_train_step(
            BATCH, SEQ, cfg, m_dtype=m_dtype, emit_compute=emit, device=dev,
            use_flat_kernel=args.flat_kernel, optimizer=args.optimizer)
        state = list(make_state())
        for _ in range(2):
            *state, _ = step(*state, ids, mask)
        t_grads, t_opt = [], []
        for _ in range(3):
            master, opt_state, scaler = state[:3]
            compute = state[3] if emit else None
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            p, _, grads, found, scaler = step.grads(master, scaler, ids,
                                                    mask, compute)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            kw = dict(found_inf=found)
            if emit:
                kw["compute_params"] = p
            state = [*step.opt.step(grads, master, opt_state, **kw)]
            state.insert(2, scaler)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            t_grads.append((t1 - t0) * 1e3)
            t_opt.append((t2 - t1) * 1e3)
        phases = {"grads_ms": statistics.median(t_grads),
                  "optimizer_ms": statistics.median(t_opt)}
        print(f"{mode}: gradient half {phases['grads_ms']:.1f} ms, "
              f"{type(step.opt).__name__} step "
              f"{phases['optimizer_ms']:.1f} ms (medians "
              "of 3, host clock around synchronised work)")

        def one_step():
            nonlocal state
            *state, _ = step(*state, ids, mask)

        res[mode] = dict(phases, **window(f"{mode}: one step", one_step,
                                          groups=group, n_top=12))
        del state, step
        torch.cuda.empty_cache()
    print(json.dumps(res))


if __name__ == "__main__":
    main()

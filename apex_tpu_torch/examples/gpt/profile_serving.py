"""Where the serving path's time goes, under ``torch.profiler``: GPT-2
medium (random weights from seed 0, O2 bf16) on an 8-slot, 1024-row
dense engine, over two windows —

- 4 decode-only ticks with all 8 slots occupied (128-token prompts);
- one prefill of a 1000-token prompt (bucket 1024).

For each window it prints the wall time (profiler on, so it includes
the profiler's cost), the summed device time of the kernels and copies
the profiler saw, their share of the wall, and the top device entries;
then one JSON line with the same numbers. ``--w8`` profiles the same
windows on the weight-only int8 tree of those params
(``quant.quantize_params`` after the O2 cast, bf16 compute), and
reports the w8 kernels' share of the device time: the counterpart of
``bench.py::_w8_decode_ab_pair``, with learned positions. ``--use-rope``
serves the RoPE model (the JAX decode benchmark's, ``bench.py``'s
``_decode_bench_setup``) and reports RoPE's device time and kernel
count in each window. Runs on the CUDA device::

    python -m apex_tpu_torch.examples.gpt.profile_serving [--w8] \
        [--use-rope]
"""

import argparse
import contextlib
import dataclasses
import json
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from apex_tpu_torch import amp
from apex_tpu_torch.models.gpt import gpt_medium, init_gpt
from apex_tpu_torch.quant import quantize_params
from apex_tpu_torch.serving import (
    ContinuousBatchingScheduler, DecodeEngine, Request,
)
from apex_tpu_torch.utils.platform import resolve_device


def device_ms(prof):
    """Device ms per profiler key, CUDA entries only (a ``rope`` range of
    :func:`rope_marked` shows on the device's timeline too, spanning its
    kernels and the gaps between them: it is left out)."""
    out = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA \
                or e.key == "rope":
            continue
        t = getattr(e, "self_device_time_total", 0.0) or getattr(
            e, "device_time_total", 0.0)
        out[e.key] = out.get(e.key, 0.0) + t / 1e3
    return out


@contextlib.contextmanager
def rope_marked():
    """Run the models' RoPE (the angle table and the rotation of q and
    k, ``models.gpt._rope_or_none`` and ``_rotate``) under profiler
    ranges named ``rope``, patched in for the block only."""
    import apex_tpu_torch.models.gpt as gpt
    import apex_tpu_torch.serving.decode as decode

    def mark(fn):
        def marked(*args, **kw):
            with record_function("rope"):
                return fn(*args, **kw)
        return marked

    saved = [(m, n, getattr(m, n)) for m, n in (
        (gpt, "_rotate"), (gpt, "_rope_or_none"), (decode, "_rope_or_none"))]
    for m, n, fn in saved:
        setattr(m, n, mark(fn))
    try:
        yield
    finally:
        for m, n, fn in saved:
            setattr(m, n, fn)


def rope_kernels(prof):
    """(device ms, kernel count) of the kernels launched inside a
    ``rope`` range (:func:`rope_marked`) or by RoPE's backward
    (``_RopeCoreBackward``)."""
    def ours(e):
        while e is not None:
            if e.name == "rope" or "_RopeCoreBackward" in e.name:
                return True
            e = e.cpu_parent
        return False

    ms, n = 0.0, 0
    for e in prof.events():
        if e.kernels and ours(e):
            n += len(e.kernels)
            ms += sum(k.duration for k in e.kernels) / 1e3
    return ms, n


def window(name, work, groups=None, n_top=8, rope=False):
    """Profile ``work()``: wall ms, summed device ms, busy share and the
    ``n_top`` top device entries; ``groups`` optionally maps the per-key
    device ms to named sums, printed and returned too; ``rope`` adds
    RoPE's device ms and kernel count (:func:`rope_kernels`; run
    ``work`` inside :func:`rope_marked`)."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        work()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kern = device_ms(prof)
    busy = sum(kern.values())
    top = sorted(kern.items(), key=lambda kv: -kv[1])[:n_top]
    if busy <= 0:
        print(f"{name}: wall {wall:.2f} ms; device time not measured "
              "(the profiler saw no CUDA kernels)")
        return dict(wall_ms=wall, device_ms=None)
    print(f"{name}: wall {wall:.2f} ms, device {busy:.2f} ms "
          f"({100 * busy / wall:.1f}% busy)")
    out = dict(wall_ms=wall, device_ms=busy,
               top=[[k[:90], t] for k, t in top])
    if rope:
        out["rope_ms"], out["rope_kernels"] = rope_kernels(prof)
        print(f"    rope: {out['rope_ms']:.3f} ms ("
              f"{100 * out['rope_ms'] / busy:.1f}%), "
              f"{out['rope_kernels']} kernels")
    if groups is not None:
        out["groups"] = groups(kern)
        print("    by group: " + ", ".join(
            f"{g} {t:.2f} ms ({100 * t / busy:.1f}%)"
            for g, t in out["groups"].items()))
    for k, t in top:
        print(f"    {t:9.3f} ms {100 * t / busy:5.1f}%  {k[:90]}")
    return out


def w8_share(kern):
    """Device ms of the w8 kernels (their CUDA symbols) and the rest."""
    w8 = sum(t for k, t in kern.items() if "w8_" in k)
    return {"w8 kernels": w8, "other": sum(kern.values()) - w8}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--w8", action="store_true",
                    help="serve the weight-only int8 tree (bf16 compute)")
    ap.add_argument("--use-rope", action="store_true",
                    help="rotary positions in place of the learned table")
    args = ap.parse_args(argv)
    dev = resolve_device(None)
    cfg = dataclasses.replace(gpt_medium(), use_rope=args.use_rope)
    params = amp.initialize("O2", verbosity=0).cast_model(
        init_gpt(cfg, torch.Generator().manual_seed(0), device=dev))
    compute_dtype, groups = None, None
    if args.w8:
        params, compute_dtype, groups = (quantize_params(params),
                                         torch.bfloat16, w8_share)
    res = {"w8": args.w8, "use_rope": args.use_rope}
    with torch.inference_mode(), rope_marked():
        eng = DecodeEngine(params, cfg, num_slots=8, max_len=1024,
                           cache_dtype=torch.bfloat16,
                           buckets=(128, 256, 512, 1024),
                           compute_dtype=compute_dtype, device=dev)
        rng = np.random.RandomState(2)
        sched = ContinuousBatchingScheduler(eng, eos_id=-1)
        for _ in range(eng.num_slots):
            sched.submit(Request(prompt=tuple(int(t) for t in rng.randint(
                0, cfg.vocab_size, size=128)), max_new_tokens=9))
        sched.step()  # admits every slot, then one decode tick
        long_prompt = [int(t) for t in rng.randint(0, cfg.vocab_size,
                                                      size=1000)]

        def ticks():
            for _ in range(4):
                sched.step()

        res["decode_4_ticks_8_slots"] = window(
            "decode_4_ticks_8_slots", ticks, groups, rope=args.use_rope)
        res["prefill_1000_tokens"] = window(
            "prefill_1000_tokens", lambda: eng.prefill(0, long_prompt),
            groups, rope=args.use_rope)
    print(json.dumps(res))


if __name__ == "__main__":
    main()

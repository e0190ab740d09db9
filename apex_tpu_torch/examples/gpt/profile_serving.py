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
count in each window.

``--paged`` profiles instead the JAX package's paged A/B configuration
(``bench.py``'s ``_paged_vs_dense_decode_ab_pair``: the RoPE GPT-2
medium, 32 slots, max_len 512, pages of 64 rows, ragged lengths from 32
to 511): one decode tick on the dense engine and one on
``PagedDecodeEngine``, each after the same 32 prompts were admitted,
with the paged decode attention's share of the paged tick's device
time, and before them one prefill of the longest prompt on each;
``--kv8`` gives the paged engine an int8 pool. ``--spec-k K`` profiles,
at the same configuration, one speculative verify tick (``spec_k`` K,
the host n-gram drafter; ``--draft-model self`` the target as its own
``DraftModel``; ``--tree`` tree speculation) against one plain tick of
the same engine shape, each after the same 32 prompts were admitted
(a random 8-32-token motif repeated to each A/B length, capped so every
slot keeps the rows of four full verify ticks), with the paged attention's share of
each tick's device time. Runs on the CUDA device::

    python -m apex_tpu_torch.examples.gpt.profile_serving [--w8] \
        [--use-rope] [--paged [--kv8]] \
        [--spec-k K [--draft-model self] [--tree]]
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
    ContinuousBatchingScheduler, DecodeEngine, DraftModel, PagedDecodeEngine,
    Request,
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


def paged_share(kern):
    """Device ms of the paged attention kernel (decode and verify) and
    the rest."""
    paged = sum(t for k, t in kern.items() if "paged_attention" in k)
    return {"paged attention": paged, "other": sum(kern.values()) - paged}


def ab_lengths(slots=32, s_max=512):
    """The paged A/B ladder (``bench.py``: ``s_max // 16`` to ``s_max``
    over the slots), each below ``s_max`` so the tick's row fits."""
    lo = s_max // 16
    return [min(lo + round(i * (s_max - lo) / (slots - 1)), s_max - 1)
            for i in range(slots)]


def paged_ab(params, cfg, dev, kv8, compute_dtype=None):
    """One decode tick on the dense engine and one on the paged engine
    (bf16 or int8 pool) at the A/B configuration, after the same 32
    prompts were admitted."""
    lengths = ab_lengths()
    rng = np.random.RandomState(4)
    prompts = [tuple(int(t) for t in rng.randint(0, cfg.vocab_size, size=n))
               for n in lengths]
    res = {"lengths": lengths}
    engines = {
        "dense": lambda: DecodeEngine(
            params, cfg, num_slots=32, max_len=512,
            cache_dtype=torch.bfloat16, buckets=(128, 256, 512),
            compute_dtype=compute_dtype, device=dev),
        "paged": lambda: PagedDecodeEngine(
            params, cfg, num_slots=32, max_len=512, num_pages=2 + 32 * 8,
            page_size=64, cache_dtype=torch.int8 if kv8 else torch.bfloat16,
            buckets=(128, 256, 512), compute_dtype=compute_dtype,
            device=dev)}
    long_prompt = prompts[-1]
    for name, make in engines.items():
        eng = make()
        eng.prefill(0, long_prompt)            # warm-up
        eng.free_slot(0)
        res[f"prefill_{name}"] = window(
            f"prefill_{len(long_prompt)}_tokens_{name}",
            lambda: eng.prefill(0, long_prompt))
        eng.free_slot(0)
        sched = ContinuousBatchingScheduler(eng, eos_id=-1)
        for p in prompts:
            sched.submit(Request(prompt=p, max_new_tokens=4))
        sched.step()  # admits all 32 slots, then one decode tick
        sched.step()  # a second tick, outside the window
        res[f"decode_tick_{name}"] = window(
            f"decode_tick_{name}{'_kv8' if kv8 and name == 'paged' else ''}",
            sched.step, paged_share if name == "paged" else None)
        del eng, sched
        torch.cuda.empty_cache()
    return res


def spec_ab(params, cfg, dev, spec_k, draft, tree, kv8,
            compute_dtype=None):
    """One verify tick (``spec_k``; the n-gram drafter, or the target as
    its own ``DraftModel``; linear or tree) against one plain tick, each
    on ``PagedDecodeEngine`` at the A/B configuration after the same 32
    motif prompts were admitted."""
    # capped so every slot keeps the rows of four full verify ticks: a
    # slot near max_len would narrow (tree) or cancel (linear) every
    # slot's speculation
    lengths = [min(n, 512 - 4 * (spec_k + 1) - 8) for n in ab_lengths()]
    rng = np.random.RandomState(4)
    prompts = [tuple(int(t) for t in np.resize(
        rng.randint(0, cfg.vocab_size, size=rng.randint(8, 33)), n))
        for n in lengths]
    res = {"lengths": lengths, "spec_k": spec_k, "draft_model": draft,
           "tree": tree}
    for name, k in (("plain", 0), ("verify", spec_k)):
        kw = {}
        if k:
            kw = dict(spec_k=k, tree_spec=tree, draft_model=DraftModel(
                params, cfg, 32, 512, compute_dtype=compute_dtype,
                device=dev) if draft else None)
        eng = PagedDecodeEngine(
            params, cfg, num_slots=32, max_len=512, num_pages=2 + 32 * 8,
            page_size=64, cache_dtype=torch.int8 if kv8 else torch.bfloat16,
            buckets=(128, 256, 512), compute_dtype=compute_dtype,
            device=dev, **kw)
        sched = ContinuousBatchingScheduler(eng, eos_id=-1)
        for p in prompts:   # enough tokens that no slot ends in 3 ticks
            sched.submit(Request(prompt=p, max_new_tokens=3 * (k + 1) + 1))
        sched.step()  # admits all 32 slots, then one tick
        sched.step()  # a second tick, outside the window
        before = (sched.spec_ticks, sched.tokens_drafted,
                  sched.tokens_accepted)
        res[f"tick_{name}"] = window(f"tick_{name}", sched.step,
                                     paged_share)
        res[f"tick_{name}"].update(
            spec_ticks=sched.spec_ticks - before[0],
            tokens_drafted=sched.tokens_drafted - before[1],
            tokens_accepted=sched.tokens_accepted - before[2])
        del eng, sched
        torch.cuda.empty_cache()
    v, p = res["tick_verify"], res["tick_plain"]
    if v.get("device_ms") and p.get("device_ms"):
        res["verify_over_plain_device"] = v["device_ms"] / p["device_ms"]
        print(f"verify tick / plain tick device time: "
              f"{res['verify_over_plain_device']:.3f}")
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--w8", action="store_true",
                    help="serve the weight-only int8 tree (bf16 compute)")
    ap.add_argument("--use-rope", action="store_true",
                    help="rotary positions in place of the learned table")
    ap.add_argument("--paged", action="store_true",
                    help="a decode tick on the paged and on the dense "
                    "engine at the JAX package's paged A/B configuration "
                    "(RoPE, 32 slots, max_len 512, pages of 64)")
    ap.add_argument("--kv8", action="store_true",
                    help="with --paged: an int8 page pool")
    ap.add_argument("--spec-k", type=int, default=0,
                    help="with --paged: one verify tick of this draft depth "
                    "against one plain tick")
    ap.add_argument("--draft-model", choices=("self",), default=None,
                    help="with --spec-k: the target as its own draft model")
    ap.add_argument("--tree", action="store_true",
                    help="with --spec-k: tree speculation")
    args = ap.parse_args(argv)
    if args.kv8 and not args.paged:
        ap.error("--kv8 needs --paged")
    if args.spec_k and not args.paged:
        ap.error("--spec-k needs --paged")
    if (args.draft_model or args.tree) and not args.spec_k:
        ap.error("--draft-model and --tree need --spec-k")
    dev = resolve_device(None)
    cfg = dataclasses.replace(gpt_medium(),
                              use_rope=args.use_rope or args.paged)
    params = amp.initialize("O2", verbosity=0).cast_model(
        init_gpt(cfg, torch.Generator().manual_seed(0), device=dev))
    compute_dtype, groups = None, None
    if args.w8:
        params, compute_dtype, groups = (quantize_params(params),
                                         torch.bfloat16, w8_share)
    res = {"w8": args.w8, "use_rope": cfg.use_rope, "paged": args.paged,
           "kv8": args.kv8}
    if args.paged:
        with torch.inference_mode():
            if args.spec_k:
                res.update(spec_ab(params, cfg, dev, args.spec_k,
                                   args.draft_model == "self", args.tree,
                                   args.kv8, compute_dtype))
            else:
                res.update(paged_ab(params, cfg, dev, args.kv8,
                                    compute_dtype))
        print(json.dumps(res))
        return
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

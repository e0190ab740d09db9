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
each tick's device time.

``--chunked`` profiles whole serving runs instead: 16 prompts of 64-960
tokens (32 new tokens each, EOS -1, all submitted at once) on
``PagedDecodeEngine`` (GPT-2 medium with learned positions, 8 slots,
max_len 1024, 2 + 8 x 16 pages of 64, a bf16 pool), chunked at
``chunk_tokens`` 256 and monolithic, each after a one-request warm-up.
For each run it gives the device time of the chunk attention: the
kernels launched inside ``models.gpt._paged_chunk_prefill_attention``
(the page-tile write), the chunk kernel's launches and any verify
kernel launches over one slot (a decode tick launches the paged
attention kernel over all 8 slots; the profiler links no CPU range to a
kernel launched through ``ctypes``, so the launches are told apart by
name and grid in the profiler's Chrome trace), and the paged attention
kernel's time on the whole run.
Runs on the CUDA device::

    python -m apex_tpu_torch.examples.gpt.profile_serving [--w8] \
        [--use-rope] [--paged [--kv8]] \
        [--spec-k K [--draft-model self] [--tree]] [--chunked]
"""

import argparse
import contextlib
import dataclasses
import json
import os
import tempfile
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


# the profiler ranges of :func:`marked`
RANGES = ("rope", "chunk_attention")


def device_ms(prof):
    """Device ms per profiler key, CUDA entries only (a range of
    :func:`marked` shows on the device's timeline too, spanning its
    kernels and the gaps between them: it is left out)."""
    out = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA \
                or e.key in RANGES:
            continue
        t = getattr(e, "self_device_time_total", 0.0) or getattr(
            e, "device_time_total", 0.0)
        out[e.key] = out.get(e.key, 0.0) + t / 1e3
    return out


@contextlib.contextmanager
def marked(name, targets):
    """Run each ``(module, attribute)`` function of ``targets`` under a
    profiler range ``name`` (one of :data:`RANGES`), patched in for the
    block only."""
    def mark(fn):
        def marked_fn(*args, **kw):
            with record_function(name):
                return fn(*args, **kw)
        return marked_fn

    saved = [(m, n, getattr(m, n)) for m, n in targets]
    for m, n, fn in saved:
        setattr(m, n, mark(fn))
    try:
        yield
    finally:
        for m, n, fn in saved:
            setattr(m, n, fn)


def rope_marked():
    """The models' RoPE (the angle table and the rotation of q and k,
    ``models.gpt._rope_or_none`` and ``_rotate``) under ``rope``
    ranges."""
    import apex_tpu_torch.models.gpt as gpt
    import apex_tpu_torch.serving.decode as decode

    return marked("rope", ((gpt, "_rotate"), (gpt, "_rope_or_none"),
                           (decode, "_rope_or_none")))


def range_kernels(prof, name, backward=None):
    """(device ms, kernel count) of the kernels launched inside a range
    ``name`` of :func:`marked` (or by an autograd node whose name holds
    ``backward``)."""
    def ours(e):
        while e is not None:
            if e.name == name or (backward and backward in e.name):
                return True
            e = e.cpu_parent
        return False

    ms, n = 0.0, 0
    for e in prof.events():
        if e.kernels and ours(e):
            n += len(e.kernels)
            ms += sum(k.duration for k in e.kernels) / 1e3
    return ms, n


def kernel_launches(prof, *matches):
    """For each of ``matches``, (grid, device ms) of every kernel launch
    whose name holds it, read from the profiler's Chrome trace (where
    each launch keeps its grid; a profile exports its trace once)."""
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    return [[(tuple(e.get("args", {}).get("grid", ())), e["dur"] / 1e3)
             for e in events
             if e.get("cat") == "kernel" and match in e.get("name", "")]
            for match in matches]


def window(name, work, groups=None, n_top=8, rope=False, inspect=None):
    """Profile ``work()``: wall ms, summed device ms, busy share and the
    ``n_top`` top device entries; ``groups`` optionally maps the per-key
    device ms to named sums, printed and returned too; ``rope`` adds
    RoPE's device ms and kernel count (:func:`range_kernels`; run
    ``work`` inside :func:`rope_marked`); ``inspect(prof, out)`` adds
    its own readings to the returned dict."""
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
        out["rope_ms"], out["rope_kernels"] = range_kernels(
            prof, "rope", "_RopeCoreBackward")
        print(f"    rope: {out['rope_ms']:.3f} ms ("
              f"{100 * out['rope_ms'] / busy:.1f}%), "
              f"{out['rope_kernels']} kernels")
    if inspect is not None:
        inspect(prof, out)
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
        before = (sched.stats.spec_ticks, sched.stats.tokens_drafted,
                  sched.stats.tokens_accepted)
        res[f"tick_{name}"] = window(f"tick_{name}", sched.step,
                                     paged_share)
        res[f"tick_{name}"].update(
            spec_ticks=sched.stats.spec_ticks - before[0],
            tokens_drafted=sched.stats.tokens_drafted - before[1],
            tokens_accepted=sched.stats.tokens_accepted - before[2])
        del eng, sched
        torch.cuda.empty_cache()
    v, p = res["tick_verify"], res["tick_plain"]
    if v.get("device_ms") and p.get("device_ms"):
        res["verify_over_plain_device"] = v["device_ms"] / p["device_ms"]
        print(f"verify tick / plain tick device time: "
              f"{res['verify_over_plain_device']:.3f}")
    return res


def chunked_runs(params, cfg, dev, chunk=256):
    """Whole serving runs on the paged engine, chunked at ``chunk`` and
    monolithic, each profiled after a one-request warm-up, with the chunk
    attention's device time (:func:`marked` around
    ``models.gpt._paged_chunk_prefill_attention``)."""
    import apex_tpu_torch.models.gpt as gpt

    rng = np.random.RandomState(5)
    prompts = [tuple(int(t) for t in rng.randint(0, cfg.vocab_size, size=n))
               for n in rng.randint(64, 961, size=16)]
    res = {"prompt_lengths": [len(p) for p in prompts], "chunk": chunk}

    def inspect(prof, out):
        out["chunk_write_ms"], out["chunk_write_kernels"] = range_kernels(
            prof, "chunk_attention")
        # grid (parts, heads, slots): a chunk's launches cover one slot
        paged, chunk = kernel_launches(prof, "paged_attention",
                                       "chunk_attention_kernel")
        one_slot = [t for g, t in paged if len(g) > 2 and g[2] == 1]
        out["chunk_verify_ms"] = sum(one_slot)
        out["chunk_verify_launches"] = len(one_slot)
        chunk = [t for _, t in chunk]
        out["chunk_kernel_ms"] = sum(chunk)
        out["chunk_kernel_launches"] = len(chunk)
        out["chunk_attention_ms"] = (out["chunk_write_ms"]
                                     + out["chunk_kernel_ms"]
                                     + out["chunk_verify_ms"])
        out["chunk_attention_share"] = (out["chunk_attention_ms"]
                                        / out["device_ms"])
        print(f"    chunk attention: {out['chunk_attention_ms']:.3f} ms "
              f"({100 * out['chunk_attention_share']:.1f}% of the device "
              f"time): the chunk kernel {out['chunk_kernel_ms']:.3f} ms in "
              f"{out['chunk_kernel_launches']} launches, the verify kernel "
              f"{out['chunk_verify_ms']:.3f} ms in "
              f"{out['chunk_verify_launches']} one-slot launches, the page "
              f"write {out['chunk_write_ms']:.3f} ms in "
              f"{out['chunk_write_kernels']} kernels")

    for name, ct in (("chunked", chunk), ("monolithic", None)):
        eng = PagedDecodeEngine(
            params, cfg, num_slots=8, max_len=1024, num_pages=2 + 8 * 16,
            page_size=64, cache_dtype=torch.bfloat16,
            buckets=(128, 256, 512, 1024), device=dev)
        warm = ContinuousBatchingScheduler(eng, eos_id=-1, chunk_tokens=ct)
        warm.submit(Request(prompt=(1, 2, 3), max_new_tokens=2))
        warm.run()
        sched = ContinuousBatchingScheduler(eng, eos_id=-1, chunk_tokens=ct)
        for i, p in enumerate(prompts):
            sched.submit(Request(prompt=p, max_new_tokens=32, seed=i))
        chunks0 = eng.stats.prefill_chunks
        with marked("chunk_attention",
                    ((gpt, "_paged_chunk_prefill_attention"),)):
            res[name] = window(f"run_{name}", sched.run, paged_share,
                               inspect=inspect)
        res[name].update(prefill_chunks=eng.stats.prefill_chunks - chunks0,
                         decode_steps=sched.decode_steps,
                         tokens=sum(len(o.tokens)
                                    for o in sched.outcomes.values()))
        del eng, sched, warm
        torch.cuda.empty_cache()
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
    ap.add_argument("--chunked", action="store_true",
                    help="whole serving runs on the paged engine, chunked "
                    "at 256 and monolithic, with the chunk attention's "
                    "device time")
    args = ap.parse_args(argv)
    if args.kv8 and not args.paged:
        ap.error("--kv8 needs --paged")
    if args.spec_k and not args.paged:
        ap.error("--spec-k needs --paged")
    if (args.draft_model or args.tree) and not args.spec_k:
        ap.error("--draft-model and --tree need --spec-k")
    if args.chunked and (args.paged or args.w8 or args.use_rope):
        ap.error("--chunked runs alone")
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
    if args.chunked:
        with torch.inference_mode():
            res.update(chunked_runs(params, cfg, dev))
        print(json.dumps(res))
        return
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

#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``apex_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printed as it runs; any failure exits non-zero:

1. build — nvcc builds every CUDA source of the serving path (one
   process per source, all at once); TF32 is switched off so fp32
   products are full fp32.
2. kernel parity — each kernel against its plain PyTorch version on the
   same card inputs, max error beside the stated tolerance.
3. serving — GPT-2 medium (h 1024, 24 layers, 16 heads, vocab 50304),
   random weights from seed 0, O2-cast to bf16, served by the port's
   ``DecodeEngine`` + ``ContinuousBatchingScheduler`` (8 slots, max_len
   1024): 16 greedy requests of 32 tokens. The kernels' launch counts
   are read around this run. Then the headline serving contract: decode
   logits over 4 steps equal the full forward's at the same positions
   (fp32 and bf16).
4. times — each kernel at the serving path's shapes, its plain
   version, one library call computing the same function (device time:
   20 calls captured in one CUDA graph, replays timed with CUDA
   events), and the least time the card could take (bytes over
   3.35 TB/s or operations over the peak rate for their type, the
   larger).

It then prints the ``kernels`` JSON line, the card's name and power
limit, and last ``{"ok": true, "device": {...}}``. It imports neither
JAX nor the JAX package.
"""

import importlib
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
BF16_TC_FLOPS = 989e12      # dense bf16 tensor-core peak
FP32_FLOPS = 67e12          # fp32 outside the tensor cores
N_REQUESTS, NEW_TOKENS, NUM_SLOTS, MAX_LEN = 16, 32, 8, 1024
BUCKETS = (128, 256, 512, 1024)


def phase(name):
    print(f"== {name}", flush=True)


def kernel_modules():
    """The two wrapper modules (their packages re-export each function
    under the module's name, so import them by path)."""
    return (importlib.import_module(
                "apex_tpu_torch.normalization.fused_layer_norm"),
            importlib.import_module(
                "apex_tpu_torch.transformer.functional.flash_attention"))


def check(ok, msg):
    print(("ok   " if ok else "FAIL ") + msg, flush=True)
    if not ok:
        sys.exit(1)


# ---------------------------------------------------------------------------
# 1. build
# ---------------------------------------------------------------------------

def build(libs):
    from apex_tpu_torch.utils.cuda_build import build_all

    phase("build")
    t0 = time.perf_counter()
    build_all(libs)
    print(f"built {[l.name for l in libs]} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for lib in libs:
        for line in lib.build_log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {lib.name}: {line.strip()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch.backends.cuda.matmul.allow_tf32 = "
          f"{torch.backends.cuda.matmul.allow_tf32}; "
          f"cudnn.allow_tf32 = {torch.backends.cudnn.allow_tf32}",
          flush=True)


# ---------------------------------------------------------------------------
# 2. kernel parity
# ---------------------------------------------------------------------------

def _rand(gen, shape, dtype, dev, scale=1.0, shift=0.0):
    return (torch.randn(shape, generator=gen, device=dev) * scale
            + shift).to(dtype)


def ln_parity(dev):
    ln, _ = kernel_modules()
    phase("kernel parity: layer norm (tolerance: fp32 1e-5; bf16 one "
          "bf16 ulp, i.e. 2^-7 relative + 1e-5)")
    gen = torch.Generator(device=dev).manual_seed(1)
    bf, f32 = torch.bfloat16, torch.float32
    cases = [  # rows, h, x dtype, w/b dtype, mode, affine
        (1024, 1024, bf, bf, "ln", True),
        (8, 1024, bf, bf, "ln", True),
        (333, 1000, f32, f32, "ln", True),
        (1024, 1024, bf, bf, "rms", True),
        (333, 1000, f32, f32, "ln", False),
    ]
    worst = 0.0
    for rows, h, xdt, wdt, mode, affine in cases:
        x = _rand(gen, (rows, h), xdt, dev, 2.0, 0.5)
        w = _rand(gen, (h,), wdt, dev, 0.5, 1.0) if affine else None
        b = _rand(gen, (h,), wdt, dev, 0.3) \
            if affine and mode == "ln" else None
        y, mean, rstd = ln.layer_norm_fwd_kernel(x, w, b, mode, 1e-5)
        torch.cuda.synchronize()
        y0, mean0, rstd0 = ln.layer_norm_fwd_plain(x, w, b, mode, 1e-5)
        err = (y.float() - y0.float()).abs()
        rtol = 1e-5 if xdt == f32 else 2 ** -7
        ok = bool((err <= rtol * y0.float().abs() + 1e-5).all())
        ok &= bool(torch.allclose(rstd, rstd0, rtol=1e-5, atol=1e-6))
        if mode == "ln":
            ok &= bool(torch.allclose(mean, mean0, rtol=1e-5, atol=1e-6))
        e = float(err.max())
        worst = max(worst, e)
        check(ok, f"LN {mode} ({rows}, {h}) x {str(xdt)[6:]} w "
              f"{str(wdt)[6:] if affine else 'none'}: max_abs_err {e:.3g}")
    return worst


LSE_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}  # base 2, absolute


def flash_parity(dev):
    from apex_tpu_torch.models.gpt import _split_qkv

    _, fa = kernel_modules()
    phase("kernel parity: flash attention (tolerance on o per element, "
          "flash_attention.o_limit: fp32 1e-5 (|o0| + 1), bf16 2^-7 |o0| "
          "+ 2^-5 sqrt(sum p^2 v^2); on the base-2 lse: fp32 1e-4, bf16 "
          "1e-2; dropout keep masks equal)")
    gen = torch.Generator(device=dev).manual_seed(2)
    bf, f32 = torch.bfloat16, torch.float32
    cases = [  # b, h, s, d, dtype, causal, masked, rate, qkv views
        (1, 16, 1024, 64, bf, True, True, 0.0, True),
        (1, 16, 1024, 64, bf, True, True, 0.0, False),
        (2, 16, 300, 64, bf, False, True, 0.0, False),
        (1, 4, 256, 128, f32, True, False, 0.0, False),
        (1, 16, 1024, 64, bf, True, True, 0.1, False),
    ]
    worst = 0.0
    for b, h, s, d, dt, causal, masked, rate, views in cases:
        if views:  # prefill's layout: views into the fused projection
            q, k, v = _split_qkv(_rand(gen, (b, s, 3 * h * d), dt, dev), d)
        else:
            q, k, v = (_rand(gen, (b, h, s, d), dt, dev) for _ in range(3))
        mask = None
        if masked:
            mask = torch.ones((b, s), dtype=torch.int32, device=dev)
            mask[:, s - s // 10:] = 0      # a padded tail
        seed = (0x1234ABCD, 0x9876FEDC)
        kw = dict(causal=causal, scale=d ** -0.5, rate=rate)
        o, lse = fa.attention_fwd_kernel(q, k, v, mask, seed, **kw)
        torch.cuda.synchronize()
        o0, lse0 = fa.attention_fwd_plain(q, k, v, mask, seed, **kw)
        err = (o.float() - o0.float()).abs()
        lim = fa.o_limit(q, k, v, mask, o0, causal=causal, scale=d ** -0.5)
        use = float(torch.where(err > 0, err / lim, 0.0).max())
        e = float(err.max())
        fin = torch.isfinite(lse0)
        le = float((lse - lse0)[fin].abs().max())
        ok = use <= 1.0 and le <= LSE_TOL[dt]
        ok &= bool(torch.equal(torch.isfinite(lse), fin))
        worst = max(worst, e)
        check(ok, f"flash b{b} h{h} s{s} d{d} {str(dt)[6:]} causal={causal}"
              f" mask={masked} rate={rate}"
              f"{' qkv views' if views else ''}: max_abs_err o {e:.3g} "
              f"({use:.2f} of its tolerance), lse {le:.3g}")
    return worst


# ---------------------------------------------------------------------------
# 3. serving at full width
# ---------------------------------------------------------------------------

def _logits_full(params, cfg, seq):
    from apex_tpu_torch.models.gpt import apply_gpt_unsharded

    hidden = apply_gpt_unsharded(params, cfg, seq)
    table = params["embedding"]["word"]["embedding"]
    return torch.matmul(hidden, table.to(hidden.dtype).t()).float()


def decode_vs_full(params, cfg, dev, cache_dtype, label, tol):
    """Prefill one prompt, decode 4 greedy steps, and hold the 4 decode
    logits rows against the full forward at the same positions."""
    from apex_tpu_torch.serving import DecodeEngine

    eng = DecodeEngine(params, cfg, num_slots=1, max_len=MAX_LEN,
                       cache_dtype=cache_dtype, buckets=BUCKETS,
                       device=dev)
    rng = np.random.RandomState(1)
    prompt = [int(t) for t in rng.randint(0, cfg.vocab_size, size=100)]
    tok = int(eng.prefill(0, prompt)[0].argmax())
    fed, rows = [], []
    for _ in range(4):
        fed.append(tok)
        logits = eng.decode([tok], [True])
        rows.append(logits[0])
        tok = int(logits[0].argmax())
    got = torch.stack(rows)
    seq = torch.tensor([prompt + fed], device=dev)
    want = _logits_full(params, cfg, seq)[0, len(prompt):]
    err = float((got - want).abs().max())
    check(err <= tol, f"decode vs full forward ({label}), 4 steps: "
          f"max_abs_err {err:.4g} <= {tol:g} (max|logit| "
          f"{float(want.abs().max()):.3g})")
    return err


def serve(dev, ln_kernel, fa_kernel):
    from apex_tpu_torch import amp
    from apex_tpu_torch.models.gpt import gpt_medium, init_gpt
    from apex_tpu_torch.serving import (
        ContinuousBatchingScheduler, DecodeEngine, Request,
    )

    phase("serving: gpt_medium, 16 greedy requests x 32 tokens, 8 slots")
    cfg = gpt_medium()
    t0 = time.perf_counter()
    params = init_gpt(cfg, torch.Generator().manual_seed(0), device=dev)
    print(f"init_gpt (fp32, seed 0) in {time.perf_counter() - t0:.1f} s",
          flush=True)
    out = {}
    with torch.inference_mode():
        # limits: 2x the error measured on an H100 at these seeds
        # (fp32 4.3e-6 -> 1e-5; bf16 0.031 -> 0.0625)
        out["decode_err_fp32"] = decode_vs_full(
            params, cfg, dev, torch.float32, "fp32 params and cache", 1e-5)
        params = amp.initialize("O2", verbosity=0).cast_model(params)
        torch.cuda.empty_cache()
        out["decode_err_bf16"] = decode_vs_full(
            params, cfg, dev, torch.bfloat16, "O2 bf16 params and cache",
            0.0625)

        eng = DecodeEngine(params, cfg, num_slots=NUM_SLOTS,
                           max_len=MAX_LEN, cache_dtype=torch.bfloat16,
                           buckets=BUCKETS, device=dev)
        # warm-up: one short request (library handles, allocator)
        warm = ContinuousBatchingScheduler(eng, eos_id=-1)
        warm.submit(Request(prompt=(1, 2, 3), max_new_tokens=2))
        warm.run()
        sched = ContinuousBatchingScheduler(eng, eos_id=-1)
        rng = np.random.RandomState(0)
        lens = rng.randint(64, 961, size=N_REQUESTS)
        for n in lens:
            prompt = tuple(int(t) for t in rng.randint(0, cfg.vocab_size,
                                                       size=int(n)))
            sched.submit(Request(prompt=prompt, max_new_tokens=NEW_TOKENS))
        torch.cuda.synchronize()
        ln_kernel.launches = 0
        fa_kernel.launches = 0
        t0 = time.perf_counter()
        streams = sched.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"ln": ln_kernel.launches, "flash": fa_kernel.launches}
    print(f"prompt lengths {lens.tolist()}")
    reasons = [sched.outcomes[i].reason for i in range(N_REQUESTS)]
    n_tok = sum(len(s) for s in streams)
    check(len(streams) == N_REQUESTS
          and all(r == "length" for r in reasons)
          and all(len(s) == NEW_TOKENS for s in streams),
          f"{len(streams)} requests finished, reasons {set(reasons)}, "
          f"{n_tok} tokens")
    check(all(0 <= t < cfg.vocab_size for s in streams for t in s),
          "every token inside the vocabulary")
    per = 2 * cfg.num_layers + 1
    n_decode = sched.decode_steps
    want_ln = per * (N_REQUESTS + n_decode)
    want_fa = cfg.num_layers * N_REQUESTS
    check(launches["ln"] == want_ln and launches["flash"] == want_fa,
          f"launches during the run: LN {launches['ln']} (= {per} x "
          f"({N_REQUESTS} prefills + {n_decode} decode steps)), flash "
          f"{launches['flash']} (= {cfg.num_layers} x {N_REQUESTS} "
          "prefills)")
    print(f"served {n_tok} tokens in {wall:.3f} s wall: "
          f"{n_tok / wall:.1f} tokens/s (prefill included)", flush=True)
    print(f"first stream: {streams[0][:8]}...")
    out.update(launches=launches, wall_s=wall, tokens=n_tok,
               tokens_per_s=n_tok / wall, decode_steps=n_decode)
    return out


# ---------------------------------------------------------------------------
# 4. times
# ---------------------------------------------------------------------------

def time_ms(fn, reps=15, inner=20):
    """Device ms per call: ``inner`` calls captured in one CUDA graph
    (after a warm-up on a side stream), the graph replayed ``reps``
    times between CUDA events; the median. The card runs the calls back
    to back with no host dispatch between them, inputs L2-warm."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    ts = []
    for _ in range(reps):
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        ts.append(start.elapsed_time(end) / inner)
    return statistics.median(ts)


def bound(nbytes, flops, peak):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def times(dev):
    ln, fa = kernel_modules()
    phase("times (device ms per call; medians of CUDA-graph replays "
          "timed with CUDA events)")
    gen = torch.Generator(device=dev).manual_seed(3)
    res = {}
    with torch.inference_mode():
        for rows in (1024, 8):
            h = 1024
            x = _rand(gen, (rows, h), torch.bfloat16, dev)
            w = _rand(gen, (h,), torch.bfloat16, dev, 0.5, 1.0)
            b = _rand(gen, (h,), torch.bfloat16, dev, 0.3)
            t_k = time_ms(lambda: ln.layer_norm_fwd_kernel(
                x, w, b, "ln", 1e-5))
            t_p = time_ms(lambda: ln.layer_norm_fwd_plain(
                x, w, b, "ln", 1e-5))
            t_l = time_ms(lambda: F.layer_norm(x, (h,), w, b, 1e-5))
            nbytes = 2 * rows * h * 2 + 2 * h * 2 + 2 * rows * 4
            bd, by = bound(nbytes, 8 * rows * h, FP32_FLOPS)
            res[f"ln_{rows}x{h}"] = dict(ms=t_k, plain_ms=t_p,
                                         library_ms=t_l, bound_ms=bd,
                                         bound_by=by)
            print(f"LN ({rows}, {h}) bf16: kernel {t_k:.5f}, plain "
                  f"{t_p:.5f}, F.layer_norm {t_l:.5f}, bound {bd:.5f} "
                  f"({by})", flush=True)
        b_, h_, s, d = 1, 16, 1024, 64
        q, k, v = (_rand(gen, (b_, h_, s, d), torch.bfloat16, dev)
                   for _ in range(3))
        kw = dict(causal=True, scale=d ** -0.5, rate=0.0)
        t_k = time_ms(lambda: fa.attention_fwd_kernel(
            q, k, v, None, (0, 0), **kw))
        t_p = time_ms(lambda: fa.attention_fwd_plain(
            q, k, v, None, (0, 0), **kw))
        t_l = time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, scale=d ** -0.5))
        pairs = s * (s + 1) // 2
        nbytes = 4 * b_ * h_ * s * d * 2 + b_ * h_ * s * 4
        bd, by = bound(nbytes, 4 * d * pairs * b_ * h_, BF16_TC_FLOPS)
        res["flash_b1h16s1024d64"] = dict(ms=t_k, plain_ms=t_p,
                                          library_ms=t_l, bound_ms=bd,
                                          bound_by=by)
        print(f"flash b1 h16 s1024 d64 causal bf16: kernel {t_k:.5f}, "
              f"plain {t_p:.5f}, scaled_dot_product_attention {t_l:.5f}, "
              f"bound {bd:.5f} ({by})", flush=True)
    return res


def card_line():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        line = out.stdout.strip().splitlines()[0] if out.stdout.strip() \
            else ""
    except (OSError, subprocess.TimeoutExpired):
        line = ""
    return line or f"{torch.cuda.get_device_name(0)}, power limit not read"


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this "
              "script runs on a CUDA device", file=sys.stderr)
        return 2
    try:
        ln, fa = kernel_modules()
    except ImportError as e:
        print(f"chip_smoke: cannot import apex_tpu_torch ({e}); run it "
              "from the root of the repository", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = card_line()
    print(f"device: {torch.cuda.get_device_name(0)} ({card}); torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    t_start = time.perf_counter()
    build([ln.LIB, fa.LIB])
    ln_err = ln_parity(dev)
    fa_err = flash_parity(dev)
    srv = serve(dev, ln.LN_FWD, fa.FLASH_FWD)
    tm = times(dev)
    kernels = [
        dict(name="layer_norm_fwd", route="cuda",
             source="apex_tpu_torch/csrc/layer_norm.cu",
             replaces="apex_tpu/normalization/fused_layer_norm.py:76",
             launches=srv["launches"]["ln"], max_abs_err=ln_err,
             **tm["ln_1024x1024"]),
        dict(name="flash_attention_fwd", route="cuda",
             source="apex_tpu_torch/csrc/flash_attention.cu",
             replaces="apex_tpu/transformer/functional/flash_attention.py:239",
             launches=srv["launches"]["flash"], max_abs_err=fa_err,
             **tm["flash_b1h16s1024d64"]),
    ]
    print(f"LN (8, 1024) bf16 (decode shape): "
          f"{json.dumps(tm['ln_8x1024'])}")
    print(f"serving: {json.dumps(srv)}")
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

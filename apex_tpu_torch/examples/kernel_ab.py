"""Time the fused softmax forwards (rows 10-11), the w8 logits head (row
23), the softmax cross entropy (rows 8-9) and the paged attention's
decode and verify instances of this checkout against the
same CUDA sources of another checkout, in one process on one card.

    python -m apex_tpu_torch.examples.kernel_ab --other DIR [DIR ...]

Run it from the root of the repository: it times as ``chip_smoke.py``
does and imports its ``time_ms``. ``DIR`` is the root of another
checkout (or a copy with one constant changed). Each of its
``apex_tpu_torch/csrc/{fused_softmax,w8_matmul,xentropy,paged_attention}.cu``
is built with the same nvcc flags and swapped in under this checkout's
wrappers, so both sides take the same arguments and allocations (a
paged-attention source whose C entry predates the launch's query slice
is called without ``wk`` and ``q0``, over the whole window). Cases run in
turns (this, other, other, this for each other), each time the median
device ms of CUDA-graph replays of 20 back-to-back calls (5 for the
cross entropy's (8192, V) logits), inputs L2-warm. The softmax backward
and the cross-entropy forward, which neither side changes, are timed as
controls of the noise, and ``copy_`` of the logits as the card's
streaming pace for the cross entropy's bytes. Each case also says
whether both sides gave the same bits. Prints one JSON object a case,
the card's name and power limit first; then, for each library, the
static SASS instruction count of each forward, w8 NK, cross-entropy
backward and paged attention kernel (``cuobjdump -sass``), by opcode.
"""

import argparse
import collections
import ctypes
import functools
import importlib
import json
import os
import re
import subprocess
import sys

import torch

from apex_tpu_torch.utils.cuda_build import CudaLibrary, build_all

_SOURCES = ("fused_softmax", "w8_matmul", "xentropy", "paged_attention")
_MODULES = {
    "fused_softmax": "apex_tpu_torch.transformer.functional.fused_softmax",
    "w8_matmul": "apex_tpu_torch.quant.kernels",
    "xentropy": "apex_tpu_torch.contrib.xentropy",
    "paged_attention":
        "apex_tpu_torch.transformer.functional.paged_attention"}


def _other_libs(root, tag):
    libs = {}
    for name in _SOURCES:
        lib = CudaLibrary(name)
        lib.name = f"{name}_{tag}"
        lib.source = os.path.join(os.path.abspath(root), "apex_tpu_torch",
                                  "csrc", f"{name}.cu")
        libs[name] = lib
    return libs


def _cases(dev):
    fsm = importlib.import_module(
        "apex_tpu_torch.transformer.functional.fused_softmax")
    w8 = importlib.import_module("apex_tpu_torch.quant.kernels")
    xent = importlib.import_module("apex_tpu_torch.contrib.xentropy")
    from apex_tpu_torch.quant import quantize_tensor

    gen = torch.Generator(device=dev).manual_seed(0)
    bf, f32 = torch.bfloat16, torch.float32
    x = torch.randn((64, 16, 128, 128), generator=gen, device=dev).mul(8)
    x = x.to(bf)
    dy = torch.randn(x.shape, generator=gen, device=dev).to(bf)
    zero = torch.zeros((64, 1, 1, 128), dtype=torch.int32, device=dev)
    pad = zero.clone()
    pad[..., 116:] = 1
    xc = torch.randn((16, 1024, 1024), generator=gen, device=dev).mul(4)
    xc = xc.to(bf)
    y = fsm.masked_softmax_fwd_kernel(x, zero, 0.125)
    w = torch.randn((50304, 1024), generator=gen, device=dev) / 32
    wq, scale = quantize_tensor(w, -1)
    del w
    xs = {m: torch.randn((m, 1024), generator=gen, device=dev).to(bf)
          for m in (1, 8)}
    cases = [
        ("softmax_fwd (64, 16, 128, 128) bf16, zero (b, 1, 1, sk) mask",
         "fused_softmax", lambda: fsm.masked_softmax_fwd_kernel(
             x, zero, 0.125), 20),
        ("softmax_fwd (64, 16, 128, 128) bf16, padded (b, 1, 1, sk) mask",
         "fused_softmax", lambda: fsm.masked_softmax_fwd_kernel(
             x, pad, 0.125), 20),
        ("softmax_causal_fwd (16, 1024, 1024) bf16", "fused_softmax",
         lambda: fsm.causal_softmax_fwd_kernel(xc, 0.125), 20),
        ("softmax_bwd (64, 16, 128, 128) bf16 (control)", "fused_softmax",
         lambda: fsm.softmax_bwd_kernel(y, dy, 0.125), 20),
        ("w8_matmul_nk M 8, (50304, 1024) table, bf16 x, fp32 out",
         "w8_matmul", lambda: w8.w8_matmul_nk_kernel(xs[8], wq, scale, f32),
         20),
        ("w8_matmul_nk M 1, (50304, 1024) table, bf16 x, fp32 out",
         "w8_matmul", lambda: w8.w8_matmul_nk_kernel(xs[1], wq, scale, f32),
         20),
    ]
    # the cross entropy at the GPT-medium and BERT-Large steps' logits,
    # as chip_smoke.py times it (every row live, dloss the mean's), and
    # the backward at GPT-2's vocabulary, whose rows start at any even
    # byte; beside each shape, copy_ of the logits into a dx-sized buffer
    # (no kernel of either side): the card's streaming pace for the same
    # bytes
    for n, v, dt, step in ((8192, 50304, bf, "GPT-medium's step"),
                           (8192, 30522, f32, "BERT-Large's step"),
                           (8192, 50257, bf, "GPT-2's vocabulary")):
        logits = torch.randn((n, v), generator=gen, device=dev).mul(3)
        logits = logits.to(dt)
        labels = torch.randint(0, v, (n,), generator=gen, device=dev)
        dloss = torch.full((n,), 1.0 / n, device=dev)
        _, lse = xent.xentropy_fwd_plain(logits, labels, 0.0)
        name = f"({n}, {v}) {'bf16' if dt == bf else 'fp32'}, {step}"
        cases.append((f"xent_bwd {name}", "xentropy", functools.partial(
            xent.xentropy_bwd_kernel, logits, labels, lse, dloss, 0.0), 5))
        if v == 50257:
            continue
        cases += [
            (f"xent_fwd {name} (control)", "xentropy", functools.partial(
                xent.xentropy_fwd_kernel, logits, labels, 0.0), 5),
            (f"copy_ {name}: the streaming pace (no kernel of either side)",
             "xentropy", functools.partial(
                 torch.Tensor.copy_, torch.empty_like(logits), logits), 5)]
    return cases + _paged_cases(dev)


def _paged_cases(dev):
    """The paged attention as ``chip_smoke.py`` times it, one layer of
    GPT-2 medium's heads: the decode instance (k1 = 1; bf16 and int8
    pools) and the linear verify at k1 = 5, at the JAX package's A/B
    configuration (32 slots, S_max 512) and at ``serving_spec``'s 8
    slots (S_max 1024, the motif mix's lengths)."""
    from chip_smoke import (NEW_TOKENS, NUM_SLOTS, PAGE, _paged_inputs,
                            _verify_inputs, ab_lengths, spec_prompts)
    from apex_tpu_torch.models.gpt import gpt_medium

    pa = importlib.import_module(_MODULES["paged_attention"])
    gen = torch.Generator(device=dev).manual_seed(17)
    spec_lens = sorted(len(p) + NEW_TOKENS // 2
                       for p in spec_prompts(gpt_medium())[:NUM_SLOTS])
    cases = []
    for key, lengths, max_pages in (
            ("A/B (32 slots, S 512)", ab_lengths(), 8),
            ("serving_spec (8 slots, S 1024)", spec_lens, 16)):
        for kv in ("bf16", "i8") if max_pages == 8 else ("bf16",):
            args = _paged_inputs(gen, dev, lengths, PAGE, max_pages, kv,
                                 "bf16")
            cases.append((f"paged_decode {key}, {kv} pool",
                          "paged_attention", functools.partial(
                              pa.paged_decode_attention_kernel, *args), 20))
        args = _verify_inputs(gen, dev, [min(n, PAGE * max_pages - 5)
                                         for n in lengths], PAGE, max_pages,
                              "bf16", "bf16", 5, False, contiguous=True)
        cases.append((f"paged_verify k1 5 {key}, bf16 pool, linear",
                      "paged_attention", functools.partial(
                          pa.paged_verify_attention_kernel, *args), 20))
    return cases


def _entry(lib, kernel):
    """``lib``'s C function for ``kernel``. A paged-attention source from
    before the launch's query slice (its entry takes no ``wk`` and
    ``q0``) is called without them, over the whole window only."""
    fn = getattr(lib.load(), kernel.symbol)
    fn.restype = ctypes.c_int
    with open(lib.source) as f:
        sliced = "int q0" in f.read()
    if kernel.symbol != "apx_paged_attention" or sliced:
        fn.argtypes = kernel.argtypes
        return fn
    # (9 pointers, b, nh, wk, q0, nq, page, ...) -> (9 pointers, b, nh,
    # k1, page, ...)
    fn.argtypes = kernel.argtypes[:11] + kernel.argtypes[13:]

    def whole_window(*a):
        wk, q0, nq = a[11:14]
        if q0 != 0 or nq != wk:
            raise ValueError(f"{lib.source} launches the whole window "
                             "only")
        return fn(*a[:11], *a[13:])

    return whole_window


def _swapped(lib_of, fn, source):
    """``fn`` with every kernel of ``source`` bound to ``lib_of[source]``
    (None: this checkout's)."""
    mod = importlib.import_module(_MODULES[source])
    lib = lib_of.get(source) if lib_of else None

    def run():
        kernels = [k for k in vars(mod).values()
                   if type(k).__name__ == "Kernel"]
        saved = [(k, k.lib, k._fn) for k in kernels]
        saved_lib = mod.LIB
        try:
            if lib is not None:
                for k in kernels:
                    k.lib, k._fn = lib, _entry(lib, k)
                mod.LIB = lib
            return fn()
        finally:
            for k, kl, kf in saved:
                k.lib, k._fn = kl, kf
            mod.LIB = saved_lib

    return run


def _same_bits(a, b):
    a, b = (t if isinstance(t, tuple) else (t,) for t in (a, b))
    return all(torch.equal(x, y) for x, y in zip(a, b))


_SASS_KERNELS = ("softmax_fwd", "w8_mma_nk", "w8_gemv_nk", "xent_bwd_kernel",
                 "paged_attention_kernel")


def sass_counts(lib):
    """{kernel name: (instructions, the most frequent opcodes)} of the
    kernels in ``_SASS_KERNELS``, from the built library's SASS."""
    from torch.utils.cpp_extension import CUDA_HOME

    dump = subprocess.run(
        [os.path.join(CUDA_HOME, "bin", "cuobjdump"), "-sass", lib.path],
        capture_output=True, text=True).stdout
    # "/*0a70*/  @!P0 PRMT R5, ..." -> PRMT
    opcode = re.compile(
        r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)")
    found = []
    for block in dump.split("Function : ")[1:]:
        name = block.splitlines()[0].strip()
        if any(k in name for k in _SASS_KERNELS):
            found.append((name, opcode.findall(block)))
    names = subprocess.run(["c++filt"], input="\n".join(n for n, _ in found),
                           capture_output=True, text=True).stdout.split("\n")
    return {plain or name: (len(ops),
                            dict(collections.Counter(ops).most_common(8)))
            for (name, ops), plain in zip(found, names)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", nargs="+", required=True,
                    help="roots of the checkouts to time against this one")
    args = ap.parse_args(argv)
    from chip_smoke import time_ms   # the kernel table's timing

    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    print(json.dumps({"card": card, "torch": torch.__version__}),
          flush=True)
    others = [_other_libs(root, f"ab{i}") for i, root in
              enumerate(args.other)]
    libs = [importlib.import_module(_MODULES[name]).LIB
            for name in _SOURCES] + [lib for o in others
                                     for lib in o.values()]
    build_all(libs)
    for lib in libs:
        for line in lib.build_log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {lib.name}: {line.strip()}")
    with torch.inference_mode():
        for label, source, fn, inner in _cases(dev):
            this = _swapped(None, fn, source)
            row = {"case": label, "this_ms": [], "other_ms": {},
                   "same_bits": {}}
            for root, o in zip(args.other, others):
                that = _swapped(o, fn, source)
                t = [time_ms(this, inner=inner), time_ms(that, inner=inner),
                     time_ms(that, inner=inner), time_ms(this, inner=inner)]
                row["this_ms"] += [t[0], t[3]]
                row["other_ms"][root] = [t[1], t[2]]
                row["same_bits"][root] = _same_bits(this(), that())
            print(json.dumps(row), flush=True)
    for lib in libs:
        for name, (n, ops) in sass_counts(lib).items():
            print(json.dumps({"library": lib.name, "kernel": name,
                              "sass_instructions": n, "top": ops}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

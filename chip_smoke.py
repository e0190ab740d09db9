#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``apex_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printed as it runs; any failure exits non-zero:

1. build — nvcc builds every CUDA source (layer norm, flash attention,
   softmax cross entropy, fused softmax, the multi-tensor kernels, the
   int8 weight-only matmuls, the threefry bits and dropout; one process
   per source, all at once); TF32
   is switched off so fp32 products and convolutions are full fp32.
2. kernel parity — each kernel against its plain PyTorch version on the
   same card inputs, max error beside the stated tolerance: the
   forwards of the serving path, then the LayerNorm and flash-attention
   backward kernels and the softmax cross entropy at the training
   path's shapes, held per element to their modules' error models (the
   bf16 flash forward, dq and dk/dv, on the tensor cores, also at
   ragged s, one row either side of the 64-row q tile and a causal run
   whose last q tile holds one row, d = 48, 100 and 128, dropout 0.1
   and 0.5, GPT and BERT views, by both load variants; the LayerNorm
   backward also at ragged h, 1000 and 1001; a second launch gives the
   same bits; the dropout keep masks read off the forward and dk/dv
   equal the plain mask); the
   fused softmax forwards (masked, causal) and backward, per element to
   their error model (uint8 and int32 masks read as vectors, a strided
   and a per-query mask, a query count off the block's rows, sk 130 and
   3000 on the generic path, a fully masked batch uniform at 1/sk, a
   repeat the same bits); ``flat_adam`` on BERT-Large's flat buffer, bit for
   bit; on the same buffer (336,232,448 elements) ``flat_scale`` and
   ``flat_axpby`` (outputs and finite flags bit for bit, with an
   injected inf and NaN), ``flat_l2norm_partials`` (to the sum-of-squares
   model, and the same bits on a repeat) and LAMB's stage 1 (m, v and u
   bit for bit, its partials to that model, the params through stage 2
   to ``lamb_p_limit``; found_inf writes the old values; two
   ``flat_lamb`` calls give the same bits); ``flat_sgd`` (five cases:
   first run, dampening, Nesterov, ``wd_after_momentum``, no momentum;
   each with an fp32 and a bf16 buffer, the latter with the cast-out),
   ``flat_adagrad`` (both modes, with and without the cast-out) and
   ``flat_novograd`` (fp32 m, and bf16 m with the cast-out;
   ``reg_inside_moment`` both ways; step 1 and step 2), all in place, bit
   for bit and the same bits on a repeat, found_inf leaving params and
   state as they were, NovoGrad's per-tensor v through the partials
   kernel to the sum-of-squares model; the int8 weight-only matmuls
   (``w8_matmul`` with and without bias, ``w8_matmul_nk``) at GPT-2
   medium's decode shapes and its prefill buckets M 128, 512 and 1024
   (bf16 x there on the tensor cores), M 37 and 100, a ragged shape and
   an x view 2 bytes past a 16-byte boundary, the logits head at M 1, 3
   and 8 (bf16 x on the tensor cores; N off its tile, K off its loads, an
   unaligned x), per element to ``quant.kernels.w8_limit``, two launches
   the same bits, and every call at M <= 8 the same bits across two
   CUDA-graph replays. The
   LayerNorm forward also at ragged h, at teams of several warps and on
   an unaligned row base. The threefry streams (``utils.prng``): a table
   of jax 0.9.0's known answers as constants; the bits kernel bit for bit
   against its plain int64 version at 1 and 3 words, the decode tick's 8
   keys x 50304 and one key over (64, 128, 1024); the fused dropout (fp32
   and bf16, BERT-Large's hidden shape and its unfused probabilities) bit
   for bit, twice and under a CUDA-graph replay. The sampler:
   ``sample_tokens`` on the card against the CPU on (8, 50304) logits at
   temperatures 0, 0.7 and 1.3 with top_k 50, top_p 0.9 and both: the
   same tokens, or a flip inside the gumbel error model.
3. serving — GPT-2 medium (h 1024, 24 layers, 16 heads, vocab 50304),
   random weights from seed 0, O2-cast to bf16, served by the port's
   ``DecodeEngine`` + ``ContinuousBatchingScheduler`` (8 slots, max_len
   1024): 16 greedy requests of 32 tokens. The kernels' launch counts
   are set to 0 before this run and read after it. Then the headline
   serving contract: decode logits over 4 steps equal the full
   forward's at the same positions (fp32 and bf16). The weight-only
   int8 path (``serving_w8``): the fp32 params quantized
   (``quantize_params``) and served with fp32 compute and cache, 4
   decode steps against the full forward of the dequantized tree; then
   the same 16 requests on the quantized O2 params with bf16 compute,
   counts set to 0 before and read after, exact launches of every
   kernel. ``serving_sampled``: the 16 requests on the O2 params with
   the odd ones sampled at temperature 0.8 (seed = index) on
   ``DecodeEngine(top_k=50)``, twice: the replay commits the same
   streams; the bits kernel once a sampled prefill and at most once a
   decode tick.
4. training — BERT-Large width (h 1024, 16 heads, ffn 4096, vocab
   30522). (a) Two layers, batch 8, seq 128: one step of
   ``make_bert_train_step`` on the card (kernels) against the same step
   on the CPU (plain versions) from the same weights, in O0 (fp32) and
   in O2 (the LAMB master per element to ``lamb_master_limit``, each
   side's step recomputed in float64). (b) All 24 layers, O2 with the dynamic loss scaler, batch 64,
   seq 128 (the JAX headline's shape): 6 steps on one fixed batch in
   each optimizer-state mode (``fp32``, ``bf16m_castout``), counts set
   to 0 before each run and read after it; losses finite and falling,
   no overflow, exact launches per step. Both (a) and (b) run three
   configurations: ``flash_tree``, flash attention with the tree-path
   FusedAdam; ``softmax_flat``, the unfused attention
   (``fused_attention=False``: the fused softmax kernels) with the flat
   FusedAdam (``use_flat_kernel=True``: one ``flat_adam`` kernel a
   step); ``flash_lamb_flat``, flash attention with the flat FusedLAMB
   (``FusedLAMB(lr=1e-3, weight_decay=0.01, use_flat_kernel=True)``: one
   ``flat_l2norm_partials`` and one ``flat_lamb_stage1`` a step). With
   dropout (``dropout_rng``): (a) again in ``flash_tree`` and
   ``softmax_flat`` at the unchanged limits (the masks are the same bits
   on both devices), and (b) six ``flash_tree`` steps in the fp32 mode
   with hidden and attention dropout 0.1, the dropout kernel 2 (L + 1)
   times a step.
5. ResNet training — ``examples/imagenet/main_amp.py``'s step
   (``make_resnet_train_step``) in three configurations:
   ``resnet_tree_o0`` (the JAX example's defaults, the tree-path
   FusedSGD), ``resnet_flat_o0`` (``use_flat_kernel=True``: one
   ``flat_sgd`` a step) and ``resnet_flat_o2`` (amp O2, dynamic loss
   scale, bf16 convolutions, fp32 BatchNorm leaves). (a) ResNet-50 at
   full width and depth, batch 4, 64 x 64, 1000 classes: one step on
   the card against the same step on the CPU from the same weights and
   batch, each held to the same step run in float64 on the CPU (loss,
   gradients and statistics: the card no further from it than 4 times
   the CPU in O0, 1.5 times in O2, since this random-init ResNet-50
   leaves any fp32 gradient far from float64 at this size), master and
   momentum buffer per element to ``sgd_master_limit``. (b) ResNet-50,
   batch 64, 224 x 224, lr 0.025 (the example's 0.1 scaled to batch 64):
   six steps of each configuration on one fixed synthetic batch, counts set
   to 0 before each run and read after it; losses finite and falling,
   exact launches (``flat_sgd`` once a step in the flat configurations,
   nothing else), the overflow count and the median step time.
6. optimizer steps — ``FusedSGD``, ``FusedAdagrad`` and
   ``FusedNovoGrad`` take three flat steps each on BERT-Large's fp32
   tree with seeded gradients, against the same optimizer's tree path
   on the card (SGD and Adagrad bit for bit, NovoGrad per element to its
   error model), exact launches a step.
7. times — each kernel at its path's shapes (the LayerNorm forward at
   (1024, 1024), (8, 1024) and the BERT O2 (8192, 1024); the w8 kernels at M
   8, 128 (rows 21-22), 1 (row 23, a prefill's logits) and 1024, rows 21-22
   also beside the bf16 serving linear on the dequantized weights;
   ``flat_sgd`` on ResNet-50's flat buffer and on BERT-Large's; the flash
   forward on contiguous tensors and on the GPT prefill's ``_split_qkv``
   views), its plain version, one library call computing the same function
   (device time: 20 calls captured in one CUDA graph, 3 for the flat kernels,
   replays timed with CUDA events), and the least time the card could take
   (bytes over 3.35 TB/s or operations over the peak rate for their type, the
   larger; for the threefry kernels the integer-ALU operations over 64
   lanes an SM at the card's maximum SM clock, with ``F.dropout`` beside
   as a different function, and the card's launch floor: a 1-element
   ``add_`` in the same harness).
8. GPT: RoPE and training — the JAX package's decode benchmark's RoPE
   model (``bench.py``'s ``_decode_bench_setup``) and its tp=1
   GPT-medium step (``gpt_tp_bench(on_tpu, n_devices=1)``). Kernel
   parity at the step's shapes: the causal flash forward, dq and dk/dv
   at b 8, h 16, s 1024, d 64 on RoPE'd q and k beside a view v (with
   and without a key mask), the cross entropy on (8192, 50304) bf16
   logits; RoPE on the card against the CPU (training shape, the decode
   tick with per-slot positions, the cached form's dcos and dsin) and
   its device time a call. ``serving_rope``: GPT-2 medium with
   ``use_rope=True`` (no position table), decode logits against the full
   forward (fp32 1e-5, O2 0.0625), the 16 requests twice on the O2
   params: the replay commits the same streams, exact launches. GPT
   training card vs CPU: GPT-medium width at 2 layers, batch 2, seq 256,
   one ``make_gpt_train_step`` step with fp32 and bf16 compute, each
   with learned positions and RoPE, and bf16 RoPE with dropout 0.1, to
   the BERT check's limits. ``gpt_training``: full GPT-medium (24
   layers, remat), batch 8, seq 1024, bf16 compute over fp32 params,
   six steps on one batch from ``randint(PRNGKey(1000))`` (labels =
   ids) as ``gpt_tree`` (the JAX step exactly, tree FusedAdam) and
   ``gpt_rope_dropout`` (RoPE, dropout 0.1 on ``fold_in(PRNGKey(0),
   step)``, flat FusedAdam): finite, falling losses and each kernel's
   launches a step exactly ``gpt_per_step_launches``. Then
   ``examples/gpt/pretrain_gpt.py`` at its defaults (finite losses,
   DONE), and the step's kernels timed at its shapes beside SDPA's
   causal forward and backward, ``F.cross_entropy`` on bf16 and
   ``torch._fused_adamw_`` over GPT-medium's tensors.

It then prints the ``kernels`` JSON line (the rows redesigned since
their port carry ``redesigned`` and a ``note`` naming the design), the
card's name and power limit, and last ``{"ok": true, "device":
{...}}``. It imports neither
JAX nor the JAX package.
"""

import importlib
import itertools
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
    """The seven wrapper modules (the packages re-export some functions
    under their modules' names, so import them by path)."""
    return (importlib.import_module(
                "apex_tpu_torch.normalization.fused_layer_norm"),
            importlib.import_module(
                "apex_tpu_torch.transformer.functional.flash_attention"),
            importlib.import_module("apex_tpu_torch.contrib.xentropy"),
            importlib.import_module(
                "apex_tpu_torch.transformer.functional.fused_softmax"),
            importlib.import_module(
                "apex_tpu_torch.multi_tensor_apply.kernels"),
            importlib.import_module("apex_tpu_torch.quant.kernels"),
            importlib.import_module("apex_tpu_torch.utils.prng"))


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
    ln = kernel_modules()[0]
    phase("kernel parity: layer norm (tolerance: fp32 1e-5; bf16 one "
          "bf16 ulp, i.e. 2^-7 relative + 1e-5)")
    gen = torch.Generator(device=dev).manual_seed(1)
    bf, f32 = torch.bfloat16, torch.float32
    cases = [  # rows, h, x dtype, w/b dtype, mode, affine
        (1024, 1024, bf, bf, "ln", True),
        (8, 1024, bf, bf, "ln", True),
        (8192, 1024, bf, f32, "ln", True),    # the BERT O2 step
        (333, 1000, f32, f32, "ln", True),
        (1024, 1024, bf, bf, "rms", True),
        (333, 1000, f32, f32, "ln", False),
        # ragged h, teams of several warps, a row base 2 bytes past a
        # 16-byte boundary (element loads)
        (16, 100, bf, bf, "ln", True),
        (33, 4096, bf, f32, "ln", True),
        (9, 8192, f32, f32, "rms", True),
        (1024, 4096, bf, f32, "ln", True),
        (40, 1024, bf, bf, "ln_unaligned", True),
    ]
    worst = 0.0
    for rows, h, xdt, wdt, mode, affine in cases:
        x = _rand(gen, (rows, h), xdt, dev, 2.0, 0.5)
        if mode == "ln_unaligned":
            mode = "ln"
            buf = torch.empty(rows * h + 1, dtype=xdt, device=dev)
            x = buf[1:].view(rows, h).copy_(x)
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


def _load_variant(*ts):
    """How the flash C entries take these tensors' tiles: fp32 on the
    CUDA cores; bf16 by 16-byte cp.async copies where every row of each
    tensor starts on a 16-byte boundary and d fills whole copies, by
    element loads otherwise."""
    if ts[0].dtype == torch.float32:
        return "fp32 CUDA cores"
    rows16 = ts[0].shape[-1] % 8 == 0 and all(
        t.data_ptr() % 16 == 0 and all(st % 8 == 0 for st in t.stride()[:3])
        for t in ts)
    return "cp.async" if rows16 else "element loads"


def _flash_qkv(gen, layout, b, h, s, d, dt, dev):
    """q, k, v as the model paths hand them over: GPT's prefill views of
    a fused (b, s, 3 h d) projection, BERT's views of a (b, s, 3, h, d)
    one, or contiguous (b, h, s, d) tensors."""
    from apex_tpu_torch.models.gpt import _split_qkv

    if layout == "gpt":
        return _split_qkv(_rand(gen, (b, s, 3 * h * d), dt, dev), d)
    if layout == "bert":
        qkv = _rand(gen, (b, s, 3, h, d), dt, dev)
        return tuple(qkv[:, :, j].transpose(1, 2) for j in range(3))
    return tuple(_rand(gen, (b, h, s, d), dt, dev) for _ in range(3))


def _flash_mask(b, s, dev, tail):
    """Batch 0's first key masked (under causal its row 0 sees nothing)
    and a padded tail of s // tail keys."""
    mask = torch.ones((b, s), dtype=torch.int32, device=dev)
    mask[0, 0] = 0
    mask[:, s - s // tail:] = 0
    return mask


def flash_parity(dev):
    fa = kernel_modules()[1]
    phase("kernel parity: flash attention (tolerance on o per element, "
          "flash_attention.o_limit: fp32 1e-5 (|o0| + 1), bf16 2^-7 |o0| "
          "+ 2^-5 sqrt(sum p^2 v^2); on the base-2 lse: fp32 1e-4, bf16 "
          "1e-2; a second launch gives the same bits; bf16 on the tensor "
          "cores, by cp.async or element loads)")
    gen = torch.Generator(device=dev).manual_seed(2)
    bf, f32 = torch.bfloat16, torch.float32
    cases = [  # b, h, s, d, dtype, causal, masked, rate, q/k/v layout
        (1, 16, 1024, 64, bf, True, True, 0.0, "gpt"),
        (1, 16, 1024, 64, bf, True, True, 0.0, None),
        (2, 16, 300, 64, bf, False, True, 0.0, None),
        (1, 4, 256, 128, f32, True, False, 0.0, None),
        (1, 16, 1024, 64, bf, True, True, 0.1, None),
        (64, 16, 128, 64, bf, False, True, 0.0, "bert"),  # the BERT step
        (64, 16, 128, 64, bf, False, True, 0.1, "bert"),
        (1, 16, 1024, 64, bf, True, True, 0.5, "gpt"),
        (2, 16, 40, 64, bf, False, True, 0.5, None),
        (2, 16, 130, 64, bf, True, True, 0.1, "gpt"),
        (2, 16, 300, 128, bf, True, True, 0.5, None),
        (2, 16, 130, 100, bf, False, True, 0.1, None),   # element loads
        (2, 4, 200, 48, bf, True, True, 0.0, "bert"),
        (2, 2, 130, 64, f32, True, True, 0.2, "bert"),
    ]
    worst = 0.0
    for b, h, s, d, dt, causal, masked, rate, layout in cases:
        q, k, v = _flash_qkv(gen, layout, b, h, s, d, dt, dev)
        mask = _flash_mask(b, s, dev, 10) if masked else None
        seed = (0x1234ABCD, 0x9876FEDC)
        kw = dict(causal=causal, scale=d ** -0.5, rate=rate)
        o, lse = fa.attention_fwd_kernel(q, k, v, mask, seed, **kw)
        o2, lse2 = fa.attention_fwd_kernel(q, k, v, mask, seed, **kw)
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
        ok &= torch.equal(o, o2) and torch.equal(lse, lse2)
        if masked and causal:  # batch 0's row 0 sees no key
            ok &= bool((o[0, :, 0] == 0).all())
        worst = max(worst, e)
        check(ok, f"flash b{b} h{h} s{s} d{d} {str(dt)[6:]} causal={causal}"
              f" mask={masked} rate={rate}"
              f"{f' {layout} qkv views' if layout else ''} "
              f"({_load_variant(q, k, v)}): max_abs_err o "
              f"{e:.3g} ({use:.2f} of its tolerance), lse {le:.3g}; "
              "repeat bit-equal")
    return worst


def flash_keep_masks(dev):
    """The dropout keep mask read straight off the bf16 kernels, against
    the plain version's at every (head, q, k). Forward: q = 0 makes every
    p 1 before normalisation and v the identity (s_k = d), so o[q, j] is
    0 exactly where (q, j) is dropped. dk/dv: lse = log2 s_k makes p =
    1 / s_k and do the identity (s_q = d), so dv[k, j] = p_drop[j, k]."""
    fa = kernel_modules()[1]
    phase("kernel parity: flash dropout keep masks (forward and dk/dv, "
          "bit for bit)")
    gen = torch.Generator(device=dev).manual_seed(8)
    bf, b, h = torch.bfloat16, 2, 16
    seed = (0x1234ABCD, 0x9876FEDC)
    for d, sq, sk in ((64, 1024, 64), (128, 300, 128)):
        eye = torch.eye(d, dtype=bf, device=dev)
        for rate in (0.1, 0.5):
            kw = dict(causal=False, scale=d ** -0.5, rate=rate)
            zero = torch.zeros((b, h, sq, d), dtype=bf, device=dev)
            o, _ = fa.attention_fwd_kernel(zero, zero[:, :, :sk],
                                           eye[:sk].expand(b, h, sk, d),
                                           None, seed, **kw)
            k = _rand(gen, (b, h, sk, d), bf, dev)
            _, dv = fa.attention_dkv_kernel(
                torch.zeros((b, h, d, d), dtype=bf, device=dev), k, k, None,
                eye.expand(b, h, d, d),
                torch.full((b * h, d), float(np.log2(sk)), device=dev),
                torch.zeros((b * h, d), device=dev), seed, **kw)
            torch.cuda.synchronize()
            keep = fa._keep_mask(b, h, sq, sk, seed, rate, dev)
            keep_t = fa._keep_mask(b, h, d, sk, seed, rate, dev)
            ok = torch.equal(o != 0, keep)
            ok &= torch.equal(dv != 0, keep_t.transpose(-1, -2))
            check(ok, f"keep mask b{b} h{h} s_q {sq} s_k {sk} d{d} rate "
                  f"{rate}: forward and dk/dv equal the plain mask "
                  f"({float(keep.float().mean()):.4f} kept)")


def _held(got, want, lim):
    """(max abs error, worst share of the per-element limit)."""
    err = (got.float() - want.float()).abs()
    use = float(torch.where(err > 0, err / lim, torch.zeros(
        (), device=err.device)).max())
    return float(err.max()), use


def ln_bwd_parity(dev):
    ln = kernel_modules()[0]
    phase("kernel parity: layer norm backward (tolerance per element, "
          "fused_layer_norm.bwd_limits: the sum-order bound 2 (n - 1) "
          "2^-24 sum|terms| of each fp32 reduction, plus one ulp of a bf16 "
          "output; dgamma/dbeta must repeat bit for bit)")
    gen = torch.Generator(device=dev).manual_seed(4)
    bf, f32 = torch.bfloat16, torch.float32
    cases = [  # rows, h, x dtype, w/b dtype, mode, affine
        (8192, 1024, bf, f32, "ln", True),    # the BERT O2 step
        (1024, 1024, bf, bf, "ln", True),
        (1024, 1024, bf, bf, "rms", True),
        (333, 1000, f32, f32, "ln", False),
        (2048, 4096, bf, f32, "ln", True),    # the JAX column-split regime
        (2048, 4096, f32, f32, "ln", True),
        (1024, 1000, bf, bf, "ln", True),     # ragged h, 16-byte chunks
        (333, 1001, bf, f32, "ln", True),     # h off the chunk: elements
        (65, 8192, bf, f32, "rms", True),     # the largest h
    ]
    worst = 0.0
    for rows, h, xdt, wdt, mode, affine in cases:
        x = _rand(gen, (rows, h), xdt, dev, 2.0, 0.5)
        dy = _rand(gen, (rows, h), xdt, dev)
        w = _rand(gen, (h,), wdt, dev, 0.5, 1.0) if affine else None
        b = _rand(gen, (h,), wdt, dev, 0.3) \
            if affine and mode == "ln" else None
        _, mean, rstd = ln.layer_norm_fwd_plain(x, w, b, mode, 1e-5)
        got = ln.layer_norm_bwd_kernel(dy, x, w, b, mean, rstd)
        again = ln.layer_norm_bwd_kernel(dy, x, w, b, mean, rstd)
        torch.cuda.synchronize()
        want = ln.layer_norm_bwd_plain(dy, x, w, b, mean, rstd)
        lims = ln.bwd_limits(dy, x, w, mean, rstd, *want)
        ok, parts = True, []
        for name, g, g2, w0, lim in zip(("dx", "dgamma", "dbeta"), got,
                                        again, want, lims):
            if w0 is None:
                continue
            e, use = _held(g, w0, lim)
            ok &= use <= 1.0 and g.dtype == w0.dtype and torch.equal(g, g2)
            worst = max(worst, e)
            parts.append(f"{name} {e:.3g} ({use:.2f} of its tolerance)")
        check(ok, f"LN bwd {mode} ({rows}, {h}) x {str(xdt)[6:]} w "
              f"{str(wdt)[6:] if affine else 'none'}: max_abs_err "
              + ", ".join(parts))
    return worst


def flash_bwd_parity(dev):
    fa = kernel_modules()[1]
    phase("kernel parity: flash attention backward (tolerance per element, "
          "flash_attention.bwd_limits: the fp32 sum-order bounds carried "
          "through p and ds, one bf16 ulp of p and of ds, one ulp of the "
          "output per rounding; a second launch gives the same bits)")
    gen = torch.Generator(device=dev).manual_seed(5)
    bf, f32 = torch.bfloat16, torch.float32
    cases = [  # b, h, s, d, dtype, causal, masked, rate, q/k/v layout
        (64, 16, 128, 64, bf, False, True, 0.0, "bert"),   # the BERT step
        (1, 16, 1024, 64, bf, True, False, 0.0, None),
        (2, 16, 300, 64, bf, True, True, 0.1, None),
        (1, 4, 256, 128, f32, True, False, 0.0, None),
        (64, 16, 128, 64, bf, False, True, 0.1, "bert"),
        (1, 16, 1024, 64, bf, True, True, 0.5, "gpt"),
        (2, 16, 40, 64, bf, False, True, 0.5, None),
        (2, 16, 130, 64, bf, True, True, 0.1, "bert"),
        (1, 16, 300, 128, bf, True, True, 0.5, None),
        (2, 16, 130, 100, bf, False, True, 0.1, None),   # element loads
        (2, 4, 200, 48, bf, True, True, 0.0, "gpt"),
        # the dq kernel's 64-row q tile: one row short, one over, and a
        # causal run whose last q tile holds one row
        (8, 16, 63, 64, bf, False, True, 0.0, "bert"),
        (8, 16, 65, 64, bf, False, True, 0.1, "bert"),
        (4, 16, 129, 64, bf, True, True, 0.0, "gpt"),
        (2, 16, 65, 100, bf, True, True, 0.0, None),     # element loads
    ]
    worst = {"dq": 0.0, "dkv": 0.0}
    for b, h, s, d, dt, causal, masked, rate, layout in cases:
        q, k, v = _flash_qkv(gen, layout, b, h, s, d, dt, dev)
        do = _rand(gen, (b, h, s, d), dt, dev)
        mask = _flash_mask(b, s, dev, 8) if masked else None
        seed = (0x1234ABCD, 0x9876FEDC)
        kw = dict(causal=causal, scale=d ** -0.5, rate=rate)
        o, lse = fa.attention_fwd_kernel(q, k, v, mask, seed, **kw)
        got = fa.attention_bwd_kernel(q, k, v, mask, o, lse, do, seed, **kw)
        again = fa.attention_bwd_kernel(q, k, v, mask, o, lse, do, seed,
                                         **kw)
        torch.cuda.synchronize()
        want = fa.attention_bwd_plain(q, k, v, mask, o, lse, do, seed, **kw)
        lims = fa.bwd_limits(q, k, v, mask, o, lse, do, *want, **kw)
        ok, parts = True, []
        for name, g, g2, w0, lim in zip(("dq", "dk", "dv"), got, again,
                                        want, lims):
            e, use = _held(g, w0, lim)
            ok &= use <= 1.0 and bool(torch.isfinite(g).all())
            ok &= torch.equal(g, g2)
            key = "dq" if name == "dq" else "dkv"
            worst[key] = max(worst[key], e)
            parts.append(f"{name} {e:.3g} ({use:.2f})")
        check(ok, f"flash bwd b{b} h{h} s{s} d{d} {str(dt)[6:]} "
              f"causal={causal} mask={masked} rate={rate}"
              f"{f' {layout} qkv views' if layout else ''} "
              f"({_load_variant(q, k, v, do)}): max_abs_err "
              "(share of its tolerance) " + ", ".join(parts)
              + "; repeat bit-equal")
    return worst


def xent_parity(dev):
    xent = kernel_modules()[2]
    phase("kernel parity: softmax cross entropy (tolerance per element, "
          "xentropy.limits: the sum-order bound of the row's logsumexp, "
          "one rounding per term; ignored rows exactly 0)")
    gen = torch.Generator(device=dev).manual_seed(6)
    n, v = 8192, 30522
    x = _rand(gen, (n, v), torch.float32, dev, 3.0)
    labels = torch.randint(0, v, (n,), generator=gen, device=dev)
    labels[torch.rand((n,), generator=gen, device=dev) < 0.15] = -1
    dloss = torch.rand((n,), generator=gen, device=dev) + 0.5
    worst = {"fwd": 0.0, "bwd": 0.0}
    for eps in (0.0, 0.1):
        loss, lse = xent.xentropy_fwd_kernel(x, labels, eps)
        dx = xent.xentropy_bwd_kernel(x, labels, lse, dloss, eps)
        torch.cuda.synchronize()
        loss0, lse0 = xent.xentropy_fwd_plain(x, labels, eps)
        dx0 = xent.xentropy_bwd_plain(x, labels, lse0, dloss, eps)
        lims = xent.limits(x, labels, eps, loss0, lse0, dloss, dx0)
        res = [_held(g, w0, lim) for g, w0, lim in zip(
            (loss, lse, dx), (loss0, lse0, dx0), lims)]
        ign = labels < 0
        ok = all(use <= 1.0 for _, use in res)
        ok &= bool((loss[ign] == 0).all()) and bool((dx[ign] == 0).all())
        worst["fwd"] = max(worst["fwd"], res[0][0], res[1][0])
        worst["bwd"] = max(worst["bwd"], res[2][0])
        check(ok, f"xentropy ({n}, {v}) fp32 eps={eps}, "
              f"{int(ign.sum())} ignored rows: max_abs_err (share of its "
              "tolerance) " + ", ".join(
                  f"{nm} {e:.3g} ({use:.2f})" for nm, (e, use) in zip(
                      ("loss", "lse", "dx"), res)))
    return worst


SM_SCALE = 0.125   # 1 / sqrt(64), BERT-Large's attention scale


def softmax_parity(dev):
    fsm = kernel_modules()[3]
    phase("kernel parity: fused softmax (tolerance per element, "
          "fused_softmax.fwd_limits: (2 (sk - 1) + 12) fp32 ulps of y for "
          "the row sums in other orders, plus one ulp of a bf16 y; "
          "backward fused_softmax.bwd_limits on the same y: 2 (sk + 1) "
          "ulps of sum |y dy| plus one ulp of a bf16 dx)")
    gen = torch.Generator(device=dev).manual_seed(8)
    bf, f32 = torch.bfloat16, torch.float32
    b, nh, s = BIG_BATCH, 16, SEQ
    worst = {"fwd": 0.0, "causal": 0.0, "bwd": 0.0}
    cases = [  # label, x dtype, fully masked rows
        ("padded tail", bf, False), ("padded tail + a fully masked row",
                                     bf, True), ("padded tail", f32, False)]
    for label, dt, full in cases:
        x = _rand(gen, (b, nh, s, s), dt, dev, 8.0)
        dy = _rand(gen, (b, nh, s, s), dt, dev)
        mask = torch.zeros((b, 1, 1, s), dtype=torch.int32, device=dev)
        mask[..., s - s // 10:] = 1          # BERT's (1 - mask): 1 = pad
        if full:
            mask[0] = 1
        y = fsm.masked_softmax_fwd_kernel(x, mask, SM_SCALE)
        dx = fsm.softmax_bwd_kernel(y, dy, SM_SCALE)
        torch.cuda.synchronize()
        y0 = fsm.masked_softmax_fwd_plain(x, mask, SM_SCALE)
        dx0 = fsm.softmax_bwd_plain(y, dy, SM_SCALE)
        ey, uy = _held(y, y0, fsm.fwd_limits(y0))
        ed, ud = _held(dx, dx0, fsm.bwd_limits(y, dy, SM_SCALE, dx0))
        ok = uy <= 1.0 and ud <= 1.0 and y.dtype == dx.dtype == dt
        if full:
            ok &= torch.equal(y[0].float(), torch.full_like(
                y[0].float(), 1.0 / s).to(dt).float())
        worst["fwd"] = max(worst["fwd"], ey)
        worst["bwd"] = max(worst["bwd"], ed)
        check(ok, f"masked softmax ({b}, {nh}, {s}, {s}) {str(dt)[6:]}, "
              f"(b, 1, 1, sk) mask, {label}: max_abs_err y {ey:.3g} "
              f"({uy:.2f} of its tolerance), dx {ed:.3g} ({ud:.2f})"
              + (", the masked rows uniform 1/sk" if full else ""))
    bc, sc = 16, 1024                        # the causal kernel's case
    x = _rand(gen, (bc, sc, sc), bf, dev, 4.0)
    dy = _rand(gen, (bc, sc, sc), bf, dev)
    y = fsm.causal_softmax_fwd_kernel(x, SM_SCALE)
    dx = fsm.softmax_bwd_kernel(y, dy, SM_SCALE)
    torch.cuda.synchronize()
    y0 = fsm.causal_softmax_fwd_plain(x, SM_SCALE)
    dx0 = fsm.softmax_bwd_plain(y, dy, SM_SCALE)
    ey, uy = _held(y, y0, fsm.fwd_limits(y0))
    ed, ud = _held(dx, dx0, fsm.bwd_limits(y, dy, SM_SCALE, dx0))
    above = bool((y[:, fsm._causal(sc, sc, dev)] == 0).all())
    worst["causal"] = ey
    worst["bwd"] = max(worst["bwd"], ed)
    check(uy <= 1.0 and ud <= 1.0 and above,
          f"causal softmax ({bc}, {sc}, {sc}) bf16: max_abs_err y {ey:.3g} "
          f"({uy:.2f} of its tolerance), dx {ed:.3g} ({ud:.2f}); zero "
          "above the diagonal")
    # the mask read as vectors (uint8 and int32, key stride 1) or element
    # by element (key stride 2), a (b, 1, sq, sk) mask, a query count off
    # the block's rows, and sk 130 and 3000 on the generic path; batch 0
    # masked everywhere
    layouts = [  # b, heads, sq, sk, mask dtype, layout
        (8, 16, 128, 128, torch.uint8, "key"),
        (8, 16, 128, 128, torch.int32, "query"),
        (4, 16, 100, 128, torch.uint8, "query"),
        (4, 16, 100, 128, torch.int32, "strided"),
        (2, 4, 37, 130, torch.uint8, "key"),
        (1, 2, 5, 3000, torch.int32, "query")]
    for b, nh, sq, sk, mdt, layout in layouts:
        x = _rand(gen, (b, nh, sq, sk), bf, dev, 8.0)
        dy = _rand(gen, (b, nh, sq, sk), bf, dev)
        ks = 2 * sk if layout == "strided" else sk
        m = torch.rand((b, 1, 1 if layout == "key" else sq, ks),
                       generator=gen, device=dev) < 0.2
        m[0] = True
        mask = m.to(mdt)[..., ::2] if layout == "strided" else m.to(mdt)
        y = fsm.masked_softmax_fwd_kernel(x, mask, SM_SCALE)
        same = torch.equal(y, fsm.masked_softmax_fwd_kernel(x, mask,
                                                            SM_SCALE))
        dx = fsm.softmax_bwd_kernel(y, dy, SM_SCALE)
        torch.cuda.synchronize()
        y0 = fsm.masked_softmax_fwd_plain(x, mask, SM_SCALE)
        dx0 = fsm.softmax_bwd_plain(y, dy, SM_SCALE)
        ey, uy = _held(y, y0, fsm.fwd_limits(y0))
        ed, ud = _held(dx, dx0, fsm.bwd_limits(y, dy, SM_SCALE, dx0))
        uniform = torch.equal(y[0], torch.full(
            y[0].shape, 1.0 / sk, device=dev).to(bf))
        worst["fwd"] = max(worst["fwd"], ey)
        worst["bwd"] = max(worst["bwd"], ed)
        check(uy <= 1.0 and ud <= 1.0 and same and uniform,
              f"masked softmax ({b}, {nh}, {sq}, {sk}) bf16, "
              f"{str(mdt)[6:]} {layout} mask: max_abs_err y {ey:.3g} "
              f"({uy:.2f} of its tolerance), dx {ed:.3g} ({ud:.2f}); a "
              "repeat the same bits, the masked batch uniform 1/sk")
    return worst


def bert_flat(dev):
    """BERT-Large's master tree packed as the flat FusedAdam packs it:
    (the fp32 params buffer, its spec)."""
    from apex_tpu_torch.models.bert import bert_large, init_bert
    from apex_tpu_torch.multi_tensor_apply.flatten import flatten_tensors
    from apex_tpu_torch.utils.tree import tree_flatten

    params = init_bert(bert_large(), torch.Generator(device=dev).manual_seed(0),
                       device=dev)
    leaves, _ = tree_flatten(params)
    return flatten_tensors(leaves)


def adam_inputs(dev, m_dtype, gen):
    from apex_tpu_torch.multi_tensor_apply.kernels import adam_hparams

    p, spec = bert_flat(dev)
    g = _rand(gen, p.shape, torch.float32, dev, 1e-3)
    m = _rand(gen, p.shape, torch.float32, dev, 1e-4).to(m_dtype)
    v = _rand(gen, p.shape, torch.float32, dev, 1e-6).abs()
    hp = adam_hparams(lr=LR, beta1=0.9, beta2=0.999, eps=1e-8,
                      step=torch.tensor(3, device=dev), weight_decay=0.01,
                      adam_w_mode=True, bias_correction=True, grad_scale=1.0,
                      device=dev)
    return g, p, m, v, hp, spec


def flat_adam_parity(dev):
    mta = kernel_modules()[4]
    phase("kernel parity: flat_adam on BERT-Large's flat buffer (tolerance: "
          "bit for bit against the plain version, the same fp32 operations "
          "in the same order; the bf16 cast-out equal to the cast of the "
          "kernel's own p; found_inf True writes the old values)")
    gen = torch.Generator(device=dev).manual_seed(9)
    worst = 0.0
    for m_dtype, emit in ((torch.float32, None),
                          (torch.bfloat16, torch.bfloat16)):
        g, p, m, v, hp, spec = adam_inputs(dev, m_dtype, gen)
        for found in (False, True):
            fi = torch.tensor(found, device=dev)
            got = mta.flat_adam_kernel(g, p, m, v, hp, fi, emit)
            torch.cuda.synchronize()
            want = mta.flat_adam_plain(g, p, m, v, hp, fi, emit)
            errs = [float((a.float() - w.float()).abs().max())
                    for a, w in zip(got, want)]
            ok = all(torch.equal(a, w) for a, w in zip(got, want))
            if emit is not None:
                ok &= torch.equal(got[3], got[0].to(torch.bfloat16))
            if found:
                ok &= torch.equal(got[0], p) and torch.equal(got[1], m) \
                    and torch.equal(got[2], v)
            worst = max([worst] + errs)
            check(ok, f"flat_adam ({spec.total_rows}, 128) = "
                  f"{p.numel()} elements, m {str(m_dtype)[6:]}"
                  f"{', bf16 cast-out' if emit else ''}, found_inf {found}: "
                  f"max_abs_err {max(errs):.3g} (p, m, v"
                  f"{', compute' if emit else ''} bit-equal)")
            del got, want
        del g, p, m, v
        torch.cuda.empty_cache()
    return worst


def _same(a, b):
    """Equal values and dtypes, a NaN where the other has one (a NaN's
    payload may differ: the kernel rounds it to bf16 as
    ``__float2bfloat16_rn`` does, PyTorch as ``c10::BFloat16``)."""
    na, nb = torch.isnan(a), torch.isnan(b)
    return a.dtype == b.dtype and torch.equal(na, nb) and torch.equal(
        a.masked_fill(na, 0), b.masked_fill(nb, 0))


def flat_scale_axpby_parity(dev):
    """``flat_scale`` and ``flat_axpby`` on BERT-Large's flat buffer:
    the kernel's output and flag against the plain version's, bit for
    bit, clean and with an injected inf (scale) or NaN (axpby)."""
    mta = kernel_modules()[4]
    phase("kernel parity: flat_scale and flat_axpby on BERT-Large's flat "
          "buffer (tolerance: outputs bit for bit, a NaN where the plain "
          "version has one; finite "
          "flags equal, scale's judged on x, axpby's on the result)")
    gen = torch.Generator(device=dev).manual_seed(11)
    x, spec = bert_flat(dev)
    y = _rand(gen, x.shape, torch.float32, dev, 1e-2)
    s = torch.tensor(1.0 / 65536, device=dev)
    ab = torch.tensor([0.9, 0.1], device=dev)
    worst = {"scale": 0.0, "axpby": 0.0}
    for bad in (None, "inf", "nan"):
        if bad is not None:   # one element in the middle of the buffer
            x.view(-1)[x.numel() // 2 + 17] = float(bad)
        for odt in (torch.float32, torch.bfloat16):
            got = mta.flat_scale_kernel(x, s, odt)
            torch.cuda.synchronize()
            want = mta.flat_scale_plain(x, s, odt)
            ok = _same(got[0], want[0]) and bool(got[1]) == bool(
                want[1]) == (bad is not None)
            e = float((got[0].float() - want[0].float()).nan_to_num().abs()
                      .max())
            worst["scale"] = max(worst["scale"], e)
            check(ok, f"flat_scale ({spec.total_rows}, 128) fp32 -> "
                  f"{str(odt)[6:]}, {bad or 'all finite'}: bit-equal, "
                  f"found_inf {bool(got[1])}")
            del got, want
        got = mta.flat_axpby_kernel(y, x, ab, torch.float32)
        torch.cuda.synchronize()
        want = mta.flat_axpby_plain(y, x, ab, torch.float32)
        ok = _same(got[0], want[0]) and bool(got[1]) == bool(
            want[1]) == (bad is not None)
        e = float((got[0] - want[0]).nan_to_num().abs().max())
        worst["axpby"] = max(worst["axpby"], e)
        check(ok, f"flat_axpby ({spec.total_rows}, 128) fp32, "
              f"{bad or 'all finite'}: bit-equal, found_inf {bool(got[1])}")
        del got, want
    del x, y
    torch.cuda.empty_cache()
    return worst


def lamb_inputs(dev, m_dtype, gen):
    """BERT-Large's flat params with random grads, moments and the
    stage-1 vector of step 3 (grad_scale / clip = 0.5)."""
    mta = kernel_modules()[4]
    p, spec = bert_flat(dev)
    g = _rand(gen, p.shape, torch.float32, dev, 1e-3)
    m = _rand(gen, p.shape, torch.float32, dev, 1e-4).to(m_dtype)
    v = _rand(gen, p.shape, torch.float32, dev, 1e-6).abs()
    hp = mta.lamb_hparams(beta1=0.9, beta2=0.999, eps=1e-6,
                          step=torch.tensor(3, device=dev), weight_decay=0.01,
                          adam_w_mode=True,
                          gs_over_clip=torch.tensor(0.5, device=dev),
                          device=dev)
    segs = (spec.tile_tensor_ids(8).to(dev), spec.tile_counts(8).to(dev))
    return g, p, m, v, hp, spec, segs


def flat_lamb_parity(dev):
    mta = kernel_modules()[4]
    phase("kernel parity: flat_l2norm_partials and LAMB's stage 1 on "
          "BERT-Large's flat buffer (tolerance: partials per element to "
          "sum_sq_limit, 2 (1024 + 1) u of each sub-tile's sum for two "
          "orders of 1,024 squares; m, v and u bit for bit; params through "
          "stage 2 to lamb_p_limit, lr |u| |d ratio| plus an ulp; repeats "
          "and two flat_lamb calls bit for bit; found_inf True writes the "
          "old m and v, u = 0 and gives the old p)")
    gen = torch.Generator(device=dev).manual_seed(12)
    out = {"l2": 0.0, "stage1": 0.0}
    for m_dtype in (torch.float32, torch.bfloat16):
        g, p, m, v, hp, spec, segs = lamb_inputs(dev, m_dtype, gen)
        label = f"({spec.total_rows}, 128) = {p.numel()} elements"
        if m_dtype == torch.float32:
            got = mta.flat_l2norm_partials_kernel(g)
            again = mta.flat_l2norm_partials_kernel(g)
            torch.cuda.synchronize()
            want = mta.flat_l2norm_partials_plain(g)
            e, use = _held(got, want, mta.sum_sq_limit(want, mta.SUB))
            out["l2"] = e
            check(use <= 1.0 and torch.equal(got, again),
                  f"flat_l2norm_partials {label}: {got.numel()} partials, "
                  f"max_abs_err {e:.3g} ({use:.3f} of its tolerance), "
                  "repeat bit-equal")
            del got, again, want
        for found in (False, True):
            fi = torch.tensor(found, device=dev)
            got = mta.flat_lamb_stage1_kernel(g, p, m, v, hp, fi)
            torch.cuda.synchronize()
            want = mta.flat_lamb_stage1_plain(g, p, m, v, hp, fi)
            ok = all(torch.equal(a, w) for a, w in zip(got[:3], want[:3]))
            errs = [float((a.float() - w.float()).abs().max())
                    for a, w in zip(got[:3], want[:3])]
            parts = [_held(a, w, mta.sum_sq_limit(w, mta.SUB))
                     for a, w in zip(got[3:], want[3:])]
            ok &= all(use <= 1.0 for _, use in parts)
            if found:
                ok &= torch.equal(got[0], m) and torch.equal(got[1], v) \
                    and not bool(got[2].any())
            # stage 2 from each side's stage 1: the ratio's sum orders
            lim = None
            p_got = mta.lamb_stage2(p, got[2], got[3], got[4], *segs,
                                    lr=1e-3, weight_decay=0.01,
                                    use_nvlamb=False)
            u_want = want[2].clone()
            p_want = mta.lamb_stage2(p, want[2], want[3], want[4], *segs,
                                     lr=1e-3, weight_decay=0.01,
                                     use_nvlamb=False)
            lim = mta.lamb_p_limit(p_want, u_want, want[3], want[4], *segs,
                                   1e-3)
            ep, up = _held(p_got, p_want, lim)
            ok &= up <= 1.0
            if found:
                ok &= torch.equal(p_got, p)
            out["stage1"] = max([out["stage1"]] + errs)
            check(ok, f"flat_lamb_stage1 {label}, m {str(m_dtype)[6:]}, "
                  f"found_inf {found}: m, v, u bit-equal (max_abs_err "
                  f"{max(errs):.3g}); partials p {parts[0][0]:.3g} "
                  f"({parts[0][1]:.3f}), u {parts[1][0]:.3g} "
                  f"({parts[1][1]:.3f}); params {ep:.3g} ({up:.3f} of "
                  "lamb_p_limit)")
            del got, want, p_got, p_want, u_want, lim
            torch.cuda.empty_cache()
        kw = dict(lr=1e-3, beta1=0.9, beta2=0.999, eps=1e-6, step=3,
                  weight_decay=0.01)
        a = mta.flat_lamb(g, p, m, v, *segs, **kw)
        b = mta.flat_lamb(g, p, m, v, *segs, **kw)
        torch.cuda.synchronize()
        check(all(torch.equal(x, y) for x, y in zip(a, b)),
              f"flat_lamb {label}, m {str(m_dtype)[6:]}: two calls give "
              "the same bits (p, m, v)")
        del a, b, g, p, m, v
        torch.cuda.empty_cache()
    return out


# flat_sgd's five cases, held bit for bit (the JAX package's FusedSGD
# cases and the first run); each also with a bf16 buffer and the cast-out
SGD_CASES = {
    "first_run": dict(momentum=0.9, weight_decay=1e-4, first_run=True),
    "dampening": dict(momentum=0.9, dampening=0.1, weight_decay=1e-4),
    "nesterov": dict(momentum=0.9, nesterov=True, weight_decay=1e-4),
    "wd_after_momentum": dict(momentum=0.9, weight_decay=1e-4,
                              wd_after_momentum=True),
    "no_momentum": dict(weight_decay=1e-4),
}
NOVO_BETAS, NOVO_EPS = (0.95, 0.98), 1e-8   # FusedNovoGrad's defaults


def _in_place_runs(kernel, plain, g, p, states, extra, found, emit):
    """An in-place kernel twice and its plain version once, each on its
    own clones of p and the states: [kernel, kernel again, plain]."""
    fi = torch.tensor(found, device=p.device)
    runs = [fn(g, p.clone(), *[s.clone() for s in states], *extra, fi, emit)
            for fn in (kernel, kernel, plain)]
    torch.cuda.synchronize()
    return runs


def _bitwise(runs, p, states, found, emit, label):
    """Check the kernel's outputs equal the plain version's and the
    repeat's, bit for bit, the cast-out the cast of its p, and a skipped
    step the old values; returns the max |kernel - plain|."""
    got, again, want = runs
    ok = len(got) == len(want) and all(
        a.dtype == w.dtype and torch.equal(a, w) and torch.equal(a, b)
        for a, b, w in zip(got, again, want))
    err = max(float((a.float() - w.float()).abs().max())
              for a, w in zip(got, want))
    if emit is not None:
        ok &= torch.equal(got[-1], got[0].to(torch.bfloat16))
    if found:
        ok &= torch.equal(got[0], p) and all(
            torch.equal(a, s) for a, s in zip(got[1:], states))
    check(ok, f"{label}, found_inf {found}: bit-equal to the plain version "
          f"and to a repeat (max_abs_err {err:.3g})")
    return err


def sgd_family_parity(dev):
    mta = kernel_modules()[4]
    phase("kernel parity: flat_sgd, flat_adagrad and flat_novograd on "
          "BERT-Large's flat buffer (tolerance: bit for bit against the "
          "plain versions, the same fp32 operations in the same order, and "
          "against a second launch; the bf16 cast-out equal to the cast of "
          "the kernel's own p; found_inf True leaves p and the state as "
          "they were. NovoGrad's per-tensor v through the L2 partials "
          "kernel: to sum_sq_limit's 2 (n + 1) u of each tensor's ||g||^2)")
    bf, f32 = torch.bfloat16, torch.float32
    gen = torch.Generator(device=dev).manual_seed(14)
    p, spec = bert_flat(dev)
    g = _rand(gen, p.shape, f32, dev, 1e-3)
    label = f"({spec.total_rows}, 128) = {p.numel()} elements"
    worst = dict(flat_sgd=0.0, flat_adagrad=0.0, flat_novograd=0.0)
    buf32 = _rand(gen, p.shape, f32, dev, 1e-3)
    for case, kw in SGD_CASES.items():
        hp = mta.sgd_hparams(**dict(dict(
            lr=0.1, momentum=0.0, dampening=0.0, weight_decay=0.0,
            nesterov=False, wd_after_momentum=False, first_run=False,
            grad_scale=1.0, device=dev), **kw))
        for buf, emit in ((buf32, None), (buf32.to(bf), bf)):
            for found in (False, True):
                runs = _in_place_runs(mta.flat_sgd_kernel,
                                      mta.flat_sgd_plain, g, p, [buf], [hp],
                                      found, emit)
                worst["flat_sgd"] = max(worst["flat_sgd"], _bitwise(
                    runs, p, [buf], found, emit,
                    f"flat_sgd {label}, {case}, buf {str(buf.dtype)[6:]}"
                    f"{', bf16 cast-out' if emit else ''}"))
                del runs
    del buf32
    torch.cuda.empty_cache()
    s = _rand(gen, p.shape, f32, dev, 1e-3).abs()
    for w_mode in (False, True):
        hp = mta.adagrad_hparams(lr=1e-2, eps=1e-10, weight_decay=0.01,
                                 adagrad_w_mode=w_mode, grad_scale=1.0,
                                 device=dev)
        for emit in (None, bf):
            for found in (False, True):
                runs = _in_place_runs(mta.flat_adagrad_kernel,
                                      mta.flat_adagrad_plain, g, p, [s],
                                      [hp], found, emit)
                worst["flat_adagrad"] = max(worst["flat_adagrad"], _bitwise(
                    runs, p, [s], found, emit,
                    f"flat_adagrad {label}, adagrad_w_mode {w_mode}"
                    f"{', bf16 cast-out' if emit else ''}"))
                del runs
    del s
    torch.cuda.empty_cache()
    ids, counts = spec.tile_tensor_ids(8).to(dev), spec.tile_counts(8).to(dev)
    v = _rand(gen, (spec.num_tensors,), f32, dev, 1e-3).abs()
    parts_k = mta.flat_l2norm_partials_kernel(g)
    parts_p = mta.flat_l2norm_partials_plain(g)
    gsq = mta.segment_sums(parts_p[:ids.numel()], counts)
    rel = 2.0 * (counts.double() * mta.SUB + 1) * mta.U
    v_use = 0.0
    m32 = _rand(gen, p.shape, f32, dev, 1e-3)
    for step in (1, 2):
        kw = dict(beta2=NOVO_BETAS[1], eps=NOVO_EPS, step=step,
                  bias_correction=True, init_zero=False)
        v_k, den_k = mta.novograd_moments(parts_k, v, counts, ids, **kw)
        v_p, _ = mta.novograd_moments(parts_p, v, counts, ids, **kw)
        # step 1 seeds v with ||g||^2, step 2 takes (1 - b2) of it
        share = 1.0 if step == 1 else 1.0 - NOVO_BETAS[1]
        e, use = _held(v_k, v_p, share * rel * gsq + 4 * mta.U * v_p)
        v_use = max(v_use, use)
        check(use <= 1.0, f"flat_novograd {label}, step {step}: per-tensor "
              f"v through the partials kernel, max_abs_err {e:.3g} ({use:.3f}"
              " of sum_sq_limit's share)")
        for m, emit in ((m32, None), (m32.to(bf), bf)):
            for reg in (False, True):
                hp = mta.novograd_hparams(
                    lr=1e-3, beta1=NOVO_BETAS[0], step=step,
                    weight_decay=0.01, grad_averaging=True,
                    bias_correction=True, reg_inside_moment=reg,
                    grad_scale=1.0, device=dev)
                for found in (False, True):
                    runs = _in_place_runs(
                        mta.flat_novograd_kernel, mta.flat_novograd_plain,
                        g, p, [m], [den_k, hp], found, emit)
                    worst["flat_novograd"] = max(
                        worst["flat_novograd"], _bitwise(
                            runs, p, [m], found, emit,
                            f"flat_novograd {label}, step {step}, m "
                            f"{str(m.dtype)[6:]}"
                            f"{', bf16 cast-out' if emit else ''}, "
                            f"reg_inside_moment {reg}"))
                    del runs
    worst["novograd_v_share"] = v_use
    del g, p, m32
    torch.cuda.empty_cache()
    return worst


# GPT-2 medium's four linears (K, N): qkv, out, fc1, fc2; and (K, N) of
# the logits head over the (50304, 1024) int8 word table
W8_LINEARS = ((1024, 3072), (1024, 1024), (1024, 4096), (4096, 1024))
W8_TABLE = (1024, 50304)


def w8_operands(gen, dev, m, k, n, xdt, nk=False, bias=True):
    """x (m, k) in ``xdt``, a quantized (k, n) (or (n, k)) weight and its
    fp32 scales, a bias in ``xdt`` (the O2 tree's)."""
    from apex_tpu_torch.quant import quantize_tensor

    w = _rand(gen, (n, k) if nk else (k, n), torch.float32, dev,
              k ** -0.5)
    wq, scale = quantize_tensor(w, -1 if nk else -2)
    x = _rand(gen, (m, k), xdt, dev)
    b = _rand(gen, (n,), xdt, dev, 0.1) if bias else None
    return x, wq, scale, b


def _graph_of(fn):
    """``fn`` captured in a CUDA graph (after a warm-up on a side
    stream), and the output tensor the replays write."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    return graph, out


def w8_parity(dev):
    w8 = kernel_modules()[5]
    phase("kernel parity: int8 weight-only matmuls (tolerance per element, "
          "quant.kernels.w8_limit: 2 K 2^-24 sum_k |x||w| for two fp32 sum "
          "orders, 2^-23 of the bias sum, one ulp of a bf16 output; two "
          "launches the same bits; at M <= 8 also across two CUDA-graph "
          "replays)")
    gen = torch.Generator(device=dev).manual_seed(14)
    bf, f32 = torch.bfloat16, torch.float32
    cases = [(m, k, n, bf, "bias") for m in (8, 1024)
             for k, n in W8_LINEARS]
    cases += [(8, 1024, 3072, f32, "bias"), (1024, 1024, 3072, f32, "bias"),
              (8, 4096, 1024, bf, "nobias"), (1, *W8_TABLE, bf, "nk"),
              (8, *W8_TABLE, bf, "nk"), (8, *W8_TABLE, f32, "nk"),
              (37, 100, 201, bf, "bias"), (37, 100, 201, f32, "nobias"),
              (37, 201, 100, bf, "nk")]   # the ragged case: byte loads
    # the logits head's tensor-core kernel (bf16 x, M <= 8): M 3, N off
    # its 16-channel tile, K off its 16-byte loads (byte loads), an x view
    # 2 bytes past a 16-byte boundary
    cases += [(3, *W8_TABLE, bf, "nk"), (8, 1024, 50300, bf, "nk"),
              (5, 200, 1000, bf, "nk"), (8, *W8_TABLE, bf, "nk_unaligned")]
    # the tensor-core kernel at the other prefill buckets, an M between 9
    # and 127, K split or not, and an x view 2 bytes past a 16-byte
    # boundary (element loads)
    cases += [(128, *W8_LINEARS[0], bf, "bias"), (512, *W8_LINEARS[2], bf,
                                                   "bias"),
              (128, *W8_LINEARS[3], bf, "nobias"),
              (512, *W8_LINEARS[3], bf, "nobias"),
              (1024, *W8_LINEARS[3], bf, "nobias"),
              (37, *W8_LINEARS[1], bf, "bias"), (100, *W8_LINEARS[3], bf,
                                                  "bias"),
              (128, *W8_LINEARS[0], bf, "bias_unaligned"),
              (1, *W8_LINEARS[0], bf, "bias")]
    worst = dict.fromkeys(("w8_matmul", "w8_matmul_nobias", "w8_matmul_nk"),
                          0.0)
    for m, k, n, xdt, kind in cases:
        nk = kind.startswith("nk")
        x, wq, scale, b = w8_operands(gen, dev, m, k, n, xdt, nk,
                                      kind.startswith("bias"))
        if kind.endswith("_unaligned"):
            buf = torch.empty(m * k + 1, dtype=xdt, device=dev)
            xv = buf[1:].view(m, k)
            xv.copy_(x)
            x = xv
        if nk:
            args = (x, wq, scale, f32)
            fk, fp = w8.w8_matmul_nk_kernel, w8.w8_matmul_nk_plain
            lim = w8.w8_limit(x, wq, scale, None, f32, nk=True)
        else:
            args = (x, wq, scale, b, xdt)
            fk, fp = w8.w8_matmul_kernel, w8.w8_matmul_plain
            lim = w8.w8_limit(x, wq, scale, b, xdt)
        got, again = fk(*args), fk(*args)
        same = torch.equal(got, again)
        note = "repeat bit-equal"
        if m <= 8:
            graph, out = _graph_of(lambda: fk(*args))
            for _ in range(2):
                graph.replay()
                torch.cuda.synchronize()
                same &= torch.equal(out, got)
            note += ", and across two CUDA-graph replays"
            del graph, out
        torch.cuda.synchronize()
        e, use = _held(got, fp(*args), lim)
        name = "w8_matmul" + ("" if kind.startswith("bias")
                              else "_nk" if nk else f"_{kind}")
        worst[name] = max(worst[name], e)
        view = f" (x at {x.data_ptr() % 16} bytes past 16)" \
            if x.data_ptr() % 16 else ""
        check(use <= 1.0 and same and got.dtype == args[-1],
              f"{name} M {m} K {k} N {n}, x {str(xdt)[6:]}{view} -> "
              f"{str(args[-1])[6:]}: max_abs_err {e:.3g} ({use:.4f} of "
              f"w8_limit), {note}")
        del x, wq, scale, b, got, again, lim
    torch.cuda.empty_cache()
    return worst


# jax 0.9.0's threefry streams (jax_threefry_partitionable=True) as
# constants, since the card's machine has no JAX (tests/test_torch_prng.py
# holds this table to the installed jax on the CPU): (call, words).
THREEFRY_KNOWN = (
    ("split(PRNGKey(0), 2)", [0x6B200159, 0x99BA4EFE, 0x375F238F,
                              0xCDDB151D]),
    ("fold_in(PRNGKey(0), 1)", [0x375F238F, 0xCDDB151D]),
    ("bits(PRNGKey(0), (4,))", [0xF29A4FA7, 0xFA843692, 0x55110E28,
                                0x77FAA835]),
    ("split(PRNGKey(42), 3)", [0x6D3E048F, 0x1022172D, 0x03D7B32D,
                               0xADD083F4, 0x92FB20EA, 0x0F38D913]),
    ("fold_in(PRNGKey(7), 2**32 - 1)", [0xDA0AA245, 0x667B358E]),
    ("bits(PRNGKey(1), (6,))", [0x704A38B7, 0x88A4083E, 0x7227B57A,
                                0x703ABFF1, 0xE5B993A4, 0x8F1716BC]),
    ("bits(fold_in(PRNGKey(3), 5), (3,))", [0x5D4A0FCC, 0x60842230,
                                            0xC6633E99]),
    ("bits(PRNGKey(-1), (2,))", [0x84B8C06F, 0x8C00439D]),
    ("uniform(PRNGKey(0), (4,)) as fp32 bits", [0x3F729A4E, 0x3F7A8436,
                                                0x3EAA221C, 0x3EEFF550]),
    ("randint(PRNGKey(1000), (6,), 0, 1000)", [244, 176, 595, 213, 280,
                                               349]),
)


def threefry_call(call, dev):
    """One row of ``THREEFRY_KNOWN`` computed by the port on ``dev`` (the
    bulk draws through the kernel on the card)."""
    p = kernel_modules()[6]
    k = p.PRNGKey
    out = {
        "split(PRNGKey(0), 2)": lambda: p.split(k(0), 2),
        "fold_in(PRNGKey(0), 1)": lambda: p.fold_in(k(0), 1),
        "bits(PRNGKey(0), (4,))": lambda: p.bits(k(0), (4,), device=dev),
        "split(PRNGKey(42), 3)": lambda: p.split(k(42), 3),
        "fold_in(PRNGKey(7), 2**32 - 1)": lambda: p.fold_in(k(7),
                                                            2 ** 32 - 1),
        "bits(PRNGKey(1), (6,))": lambda: p.bits(k(1), (6,), device=dev),
        "bits(fold_in(PRNGKey(3), 5), (3,))": lambda: p.bits(
            p.fold_in(k(3), 5), (3,), device=dev),
        "bits(PRNGKey(-1), (2,))": lambda: p.bits(k(-1), (2,), device=dev),
        "uniform(PRNGKey(0), (4,)) as fp32 bits": lambda: p.uniform(
            k(0), (4,), device=dev).view(torch.int32).to(torch.int64)
        & p.M32,
        "randint(PRNGKey(1000), (6,), 0, 1000)": lambda: p.randint(
            k(1000), (6,), 0, 1000, device=dev),
    }[call]()
    return [int(w) for w in out.reshape(-1).tolist()]


# the shapes the paths draw at: the decode tick's gumbel noise (8 slots x
# GPT-2's vocabulary), BERT-Large's hidden dropout and its unfused
# attention probabilities (batch 64, seq 128)
BITS_SHAPES = ((1, 1), (1, 3), (8, 50304), (1, 64 * 128 * 1024))
HIDDEN_SHAPE, PROBS_SHAPE = (64, 128, 1024), (64, 16, 128, 128)


def threefry_parity(dev):
    """The bits kernel and the fused dropout against their plain int64
    versions on the same card inputs, bit for bit; the known answers."""
    p = kernel_modules()[6]
    phase("kernel parity: threefry bits and dropout (bit for bit against "
          "the plain int64 version; jax 0.9.0's known answers)")
    for call, want in THREEFRY_KNOWN:
        got = threefry_call(call, dev)
        check(got == want, f"{call}: {[hex(w) for w in got]}")
    for rows, n in BITS_SHAPES:
        keys = p.split(p.PRNGKey(rows * 7 + n), rows)
        got = p.threefry_bits_kernel(keys, n, dev)
        again = p.threefry_bits_kernel(keys, n, dev)
        want = p.threefry_bits_plain(keys, n, dev)
        torch.cuda.synchronize()
        check(torch.equal(got, want) and torch.equal(got, again),
              f"bits, {rows} key(s) x {n}: equal to the plain version, "
              "twice")
    gen = torch.Generator(device=dev).manual_seed(11)
    worst = 0.0
    for shape, dt, rate in ((HIDDEN_SHAPE, torch.bfloat16, 0.1),
                            (HIDDEN_SHAPE, torch.float32, 0.1),
                            (PROBS_SHAPE, torch.bfloat16, 0.1),
                            ((1001,), torch.float32, 0.5)):
        x = _rand(gen, shape, dt, dev)
        words = p.host_bits(p.PRNGKey(len(shape)), 2)
        got = p.dropout_kernel(x, words, rate)
        again = p.dropout_kernel(x, words, rate)
        want = p.dropout_plain(x, words, rate)
        static = torch.empty_like(x)
        graph, _ = _graph_of(lambda: static.copy_(p.dropout_kernel(
            x, words, rate)))
        graph.replay()
        torch.cuda.synchronize()
        worst = max(worst, float((got.float() - want.float()).abs().max()))
        kept = float((want != 0).float().mean())
        check(torch.equal(got, want) and torch.equal(got, again)
              and torch.equal(static, got),
              f"dropout {tuple(shape)} {str(dt)[6:]} rate {rate}: equal to "
              f"the plain version, twice and under a graph replay "
              f"({kept:.4f} kept)")
    return {"threefry_bits": 0.0, "threefry_dropout": worst}


def sampler_parity(dev):
    """``sample_tokens`` on the card against the CPU on the same logits and
    keys: tokens equal, or a flip of a sampled row inside the error model
    (its two best perturbed scores within twice ``prng.gumbel_limit``, or
    its top-k / nucleus support moved: the card's softmax and running sum
    round otherwise at the boundary)."""
    from apex_tpu_torch.serving.sampling import _restrict, sample_tokens

    p = kernel_modules()[6]
    phase("sampler parity: sample_tokens on the card vs the CPU, (8, 50304) "
          "fp32 logits, temperatures 0 / 0.7 / 1.3, top_k 50, top_p 0.9 and "
          "both")
    v = 50304
    logits = torch.randn(8, v, generator=torch.Generator().manual_seed(5)) \
        * 3
    temps = torch.tensor([0.0, 0.7, 1.3, 0.7, 1.3, 0.0, 0.7, 1.3])
    keys = torch.stack([p.fold_in(p.PRNGKey(i), 3) for i in range(8)])
    out = {}
    drawn = temps > 0
    for top_k, top_p in ((0, 0.0), (50, 0.0), (0, 0.9), (50, 0.9)):
        got = sample_tokens(logits.to(dev), keys, temps.to(dev), top_k,
                            top_p).cpu()
        want = sample_tokens(logits, keys, temps, top_k, top_p)
        support = torch.isfinite(_restrict(logits, top_k, top_p))
        moved = (torch.isfinite(_restrict(logits.to(dev), top_k, top_p))
                 .cpu() != support).any(-1)
        score = torch.where(support, logits, -torch.inf) / temps.clamp(
            min=1e-6)[:, None] + p.gumbel_rows(keys, v, "cpu")
        top2 = score.topk(2).values
        gap = top2[:, 0] - top2[:, 1]
        lim = 2 * p.gumbel_limit(top2[:, 0])
        flips = int((got != want).sum())
        ok = bool(((got == want) | (drawn & ((gap <= lim) | moved))).all())
        check(ok, f"top_k {top_k}, top_p {top_p}: {flips} of 8 tokens "
              f"differ from the CPU's; smallest top-two gap of a sampled "
              f"row {float(gap[drawn].min()):.3g} (limit "
              f"{float(lim[drawn].max()):.3g}); rows whose support moved "
              f"on the card: {int(moved.sum())}")
        out[f"k{top_k}_p{top_p}"] = dict(flips=flips, min_gap=float(
            gap[temps > 0].min()))
    return out


# ---------------------------------------------------------------------------
# 3. serving at full width
# ---------------------------------------------------------------------------

def _logits_full(params, cfg, seq):
    from apex_tpu_torch.models.gpt import apply_gpt_unsharded

    hidden = apply_gpt_unsharded(params, cfg, seq)
    table = params["embedding"]["word"]["embedding"]
    return torch.matmul(hidden, table.to(hidden.dtype).t()).float()


def decode_vs_full(params, cfg, dev, cache_dtype, label, tol, ref=None):
    """Prefill one prompt, decode 4 greedy steps, and hold the 4 decode
    logits rows against the full forward of ``ref`` (default the same
    params) at the same positions."""
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
    want = _logits_full(params if ref is None else ref, cfg,
                        seq)[0, len(prompt):]
    err = float((got - want).abs().max())
    check(err <= tol, f"decode vs full forward ({label}), 4 steps: "
          f"max_abs_err {err:.4g} <= {tol:g} (max|logit| "
          f"{float(want.abs().max()):.3g})")
    return err


def dequantized(qparams):
    """The fp32 tree a weight-only int8 tree stands for: each int8 kernel
    and the word table dequantized (``dequantize_tensor``), the rest as
    it is."""
    from apex_tpu_torch.quant import dequantize_tensor

    word = qparams["embedding"]["word"]
    layers = {name: ({"kernel": dequantize_tensor(p["kernel"], p["scale"],
                                                  -2), "bias": p["bias"]}
                     if "scale" in p else p)
              for name, p in qparams["layers"].items()}
    return dict(qparams, layers=layers, embedding=dict(
        qparams["embedding"], word={"embedding": dequantize_tensor(
            word["embedding"], word["scale"], -1)}))


def serve_mix(dev, cfg, params, kern, temps=None, **engine_kw):
    """The 16-request mix on one engine (8 slots, bf16 cache), after a
    one-request warm-up; every kernel's count set to 0 just before the
    run and read just after. ``temps``: each request's temperature
    (greedy without), its seed its index. Returns the streams, launches,
    decode steps and wall time."""
    from apex_tpu_torch.serving import (
        ContinuousBatchingScheduler, DecodeEngine, Request,
    )

    eng = DecodeEngine(params, cfg, num_slots=NUM_SLOTS, max_len=MAX_LEN,
                       cache_dtype=torch.bfloat16, buckets=BUCKETS,
                       device=dev, **engine_kw)
    # warm-up: one short request (library handles, allocator)
    warm = ContinuousBatchingScheduler(eng, eos_id=-1)
    warm.submit(Request(prompt=(1, 2, 3), max_new_tokens=2))
    warm.run()
    sched = ContinuousBatchingScheduler(eng, eos_id=-1)
    rng = np.random.RandomState(0)
    lens = rng.randint(64, 961, size=N_REQUESTS)
    for i, n in enumerate(lens):
        prompt = tuple(int(t) for t in rng.randint(0, cfg.vocab_size,
                                                   size=int(n)))
        sched.submit(Request(prompt=prompt, max_new_tokens=NEW_TOKENS,
                             temperature=0.0 if temps is None else temps[i],
                             seed=i))
    torch.cuda.synchronize()
    for k in kern.values():
        k.launches = 0
    t0 = time.perf_counter()
    streams = sched.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {n: k.launches for n, k in kern.items()}
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
    print(f"served {n_tok} tokens in {wall:.3f} s wall: "
          f"{n_tok / wall:.1f} tokens/s (prefill included)", flush=True)
    print(f"first stream: {streams[0][:8]}...")
    return dict(streams=streams, launches=launches, wall_s=wall,
                tokens=n_tok, tokens_per_s=n_tok / wall,
                decode_steps=sched.decode_steps)


def check_launches(launches, want, label):
    """Every kernel's count in the run equals ``want`` (0 where absent)."""
    want = {n: want.get(n, 0) for n in launches}
    got = {n: c for n, c in launches.items() if c}
    check(launches == want, f"launches during the {label} run: {got} "
          f"(expected {({n: c for n, c in want.items() if c})}, every "
          "other kernel 0)")


def serve(dev, kern):
    from apex_tpu_torch import amp
    from apex_tpu_torch.models.gpt import gpt_medium, init_gpt
    from apex_tpu_torch.quant import quantize_params

    phase("serving: gpt_medium, 16 greedy requests x 32 tokens, 8 slots")
    cfg = gpt_medium()
    L = cfg.num_layers
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
        # the w8 steps and the dequantized tree's forward read the same
        # fp32 weights and differ only in sum orders: the fp32 limit
        qparams = quantize_params(params)
        out["decode_err_w8_fp32"] = decode_vs_full(
            qparams, cfg, dev, torch.float32, "w8 of the fp32 params, fp32 "
            "compute and cache, against the dequantized tree", 1e-5,
            ref=dequantized(qparams))
        del qparams
        params = amp.initialize("O2", verbosity=0).cast_model(params)
        torch.cuda.empty_cache()
        out["decode_err_bf16"] = decode_vs_full(
            params, cfg, dev, torch.bfloat16,
            "O2 bf16 params and cache", 0.0625)
        bf = serve_mix(dev, cfg, params, kern)
        per = 2 * L + 1
        forwards = N_REQUESTS + bf["decode_steps"]
        check_launches(bf["launches"], {
            "layer_norm_fwd": per * forwards,
            "flash_attention_fwd": L * N_REQUESTS}, "bf16 serving")
        phase("serving_w8: the same 16 requests on quantize_params of the "
              "O2 params, bf16 compute and cache")
        w8 = serve_mix(dev, cfg, quantize_params(params), kern,
                       compute_dtype=torch.bfloat16)
        forwards_w8 = N_REQUESTS + w8["decode_steps"]
        check_launches(w8["launches"], {
            "layer_norm_fwd": per * forwards_w8,
            "flash_attention_fwd": L * N_REQUESTS,
            "w8_matmul": 4 * L * forwards_w8,
            "w8_matmul_nk": forwards_w8}, "w8 serving")
        sp = serve_sampled(dev, cfg, params, kern, bf["streams"])
    pairs = [(a, b) for s, t in zip(bf["streams"], w8["streams"])
             for a, b in zip(s, t)]
    same = sum(a == b for a, b in pairs)
    print(f"greedy tokens equal to the bf16 run's (for information): "
          f"{same} of {len(pairs)}; tokens/s bf16 {bf['tokens_per_s']:.1f},"
          f" w8 {w8['tokens_per_s']:.1f}", flush=True)
    for res in (bf, w8):
        del res["streams"]
    out.update(bf16=bf, w8=w8, sampled=sp, w8_tokens_equal_to_bf16=same,
               tokens_compared=len(pairs))
    return out


SAMPLED_T, SAMPLED_TOP_K = 0.8, 50   # examples/gpt/generate.py's example


def serve_sampled(dev, cfg, params, kern, greedy_streams):
    """The 16 requests again on the O2 params, the odd ones sampled at
    temperature 0.8 with their index as seed, on DecodeEngine(top_k=50),
    twice: the replay commits the same streams; exact launches of every
    kernel but the bits kernel, whose launches are one per sampled
    prefill and one per decode tick that holds a sampled slot."""
    L = cfg.num_layers
    phase(f"serving_sampled: the same 16 requests on the O2 params, the "
          f"odd ones sampled at temperature {SAMPLED_T} (seed = request "
          f"index), DecodeEngine(top_k={SAMPLED_TOP_K}), run twice")
    temps = [SAMPLED_T if i % 2 else 0.0 for i in range(N_REQUESTS)]
    runs = [serve_mix(dev, cfg, params, kern, temps=temps,
                      top_k=SAMPLED_TOP_K) for _ in range(2)]
    sp = runs[0]
    check(runs[0]["streams"] == runs[1]["streams"],
          f"replay: the second run commits the same {N_REQUESTS} streams")
    n_sampled, steps = N_REQUESTS // 2, sp["decode_steps"]
    bits = sp["launches"]["threefry_bits"]
    check(n_sampled <= bits <= n_sampled + steps,
          f"threefry_bits launches {bits}: {n_sampled} sampled prefills "
          f"and at most one a decode tick ({steps} ticks)")
    check_launches(sp["launches"], {
        "layer_norm_fwd": (2 * L + 1) * (N_REQUESTS + steps),
        "flash_attention_fwd": L * N_REQUESTS, "threefry_bits": bits},
        "sampled serving")
    same = sum(sp["streams"][i] == greedy_streams[i]
               for i in range(0, N_REQUESTS, 2))
    print(f"greedy requests equal to the serving phase's streams (for "
          f"information): {same} of {N_REQUESTS - n_sampled}; bits launches "
          f"a decode tick {(bits - n_sampled) / steps:.3f}; smoke reading, "
          f"not a benchmark: {sp['tokens_per_s']:.1f} tokens/s (greedy "
          "run's in the serving phase)", flush=True)
    del sp["streams"]
    sp.update(greedy_equal_to_serving=same,
              bits_per_decode_tick=(bits - n_sampled) / steps,
              replay_wall_s=runs[1]["wall_s"])
    return sp


# ---------------------------------------------------------------------------
# 4. training at full width
# ---------------------------------------------------------------------------

LR = 1e-4        # make_bert_train_step's FusedAdam
LAMB_LR = 1e-3   # and its FusedLAMB
SMALL_BATCH, SMALL_LAYERS, BIG_BATCH, SEQ, BIG_STEPS = 8, 2, 64, 128, 6
# card step vs CPU step (relative norm of the difference per leaf; loss
# relative; master absolute). O0: fp32 sums of up to 30522 terms in
# other orders, about sqrt(n) 2^-24 ~ 1e-5 relative per product,
# compounded through two layers and back: 1e-4 (v, a square: 2e-4).
# Master: an Adam step moves a leaf by at most lr (|m^|/sqrt(v^) <= 1
# on the first step) beside the weight decay both share, and a gradient
# within rounding of zero may change sign, so 2 lr (plus 1e-6 for the
# roundings of p - lr u) in both levels. O2: about 4x the error measured
# on an H100 (700 W) at these seeds: loss 5.2e-6, gradients and m
# 0.025, v 0.038, master 2.0e-4 (one sign flip).
STEP_LIMITS = {
    "O0": {"loss": 1e-5, "grads": 1e-4, "m": 1e-4, "v": 2e-4,
           "master": 2 * LR + 1e-6},
    "O2": {"loss": 2e-5, "grads": 0.1, "m": 0.1, "v": 0.15,
           "master": 2 * LR + 1e-6},
}
# The flat FusedLAMB configuration: loss, gradients, m and v as above (m
# = beta3 g / clip, v its square: the clip's norm agrees far inside
# these). Master is held per element to LAMB's own error model
# (``lamb_master_limit``), as tests/test_torch_bert_train.py holds the
# port to the JAX package: each side's step p - lr r u is recomputed in
# float64 from the master before it and that side's own new m and v (u =
# m^ / (sqrt(v^) + eps) + wd p, r = ||p|| / ||u|| over the leaf), and
# the two masters may differ by the difference of those two results
# plus each side's fp32 roundings: the ratio's sums of squares ((1024 +
# k) u for the flat path's two levels over a leaf of k sub-tiles, plus
# 3 u), 16 u of u (2^-8 more with a bf16 m), 2 u of the product and an
# ulp of p. A gradient near zero that changes sign between card and CPU
# moves an element by up to 2 lr r, and the model carries it exactly;
# a step that leaves master where it was, or moves it the wrong way,
# misses by lr r |u| on every element.
LAMB_EPS, LAMB_WD = 1e-6, 0.01   # make_bert_train_step's FusedLAMB
U32 = 2.0 ** -24                 # fp32 unit roundoff

def _relnorm(got_tree, want_tree):
    from apex_tpu_torch.utils.tree import tree_leaves

    worst = 0.0
    for g, w in zip(tree_leaves(got_tree), tree_leaves(want_tree)):
        g, w = g.detach().cpu().double(), w.detach().double()
        n = float(w.norm())
        worst = max(worst, float((g - w).norm()) / (n if n > 0 else 1.0))
    return worst


def _maxabs(got_tree, want_tree):
    from apex_tpu_torch.utils.tree import tree_leaves

    return max(float((g.cpu().double() - w.double()).abs().max())
               for g, w in zip(tree_leaves(got_tree), tree_leaves(want_tree)))


KERNEL_NAMES = ("layer_norm_fwd", "layer_norm_bwd", "flash_attention_fwd",
                "flash_attention_bwd_dq", "flash_attention_bwd_dkv",
                "xentropy_fwd", "xentropy_bwd", "scaled_masked_softmax_fwd",
                "scaled_upper_triang_softmax_fwd", "fused_softmax_bwd",
                "flat_adam", "flat_scale", "flat_axpby",
                "flat_l2norm_partials", "flat_lamb_stage1",
                "w8_matmul_nobias", "w8_matmul", "w8_matmul_nk", "flat_sgd",
                "flat_adagrad", "flat_novograd", "threefry_bits",
                "threefry_dropout")
# kernels on no model path (held to their plain versions and timed)
OFF_PATH = ("scaled_upper_triang_softmax_fwd", "flat_scale", "flat_axpby",
            "w8_matmul_nobias")
# the step's three configurations, through the JAX package's own
# switches: name -> (cfg.fused_attention, the optimizer, its
# use_flat_kernel)
STEP_CONFIGS = {"flash_tree": (True, "adam", False),
                "softmax_flat": (False, "adam", True),
                "flash_lamb_flat": (True, "lamb", True)}


def _step_cfg(name, **kw):
    import dataclasses

    from apex_tpu_torch.models.bert import bert_large

    return dataclasses.replace(bert_large(),
                               fused_attention=STEP_CONFIGS[name][0], **kw)


def _key(name, label):
    """Result keys: the first configuration keeps its plain labels."""
    return label if name == "flash_tree" else f"{label} {name}"


# the configurations the dropout runs take: flash attention (the flash
# kernels' hash, seeded by bits(key, (2,))) and the unfused attention
# (Bernoulli draws on the probabilities through the dropout kernel)
DROPOUT_CONFIGS = ("flash_tree", "softmax_flat")
DROPOUT_SEED = 0


def train_small(dev):
    """One step of the 2-layer full-width model on the card and on the
    CPU from the same weights, in O0 and O2, in each configuration; then
    the same step with the model's dropout (``dropout_rng``) in the
    dropout configurations, held to the unchanged limits: the masks are
    the same bits on both devices."""
    out = {}
    for name, (_, opt, flat) in STEP_CONFIGS.items():
        cfg = _step_cfg(name, num_layers=SMALL_LAYERS)
        for level, lim in STEP_LIMITS.items():
            out[_key(name, level)] = _train_small_one(
                dev, cfg, opt, flat, level, lim, name)
    for name in DROPOUT_CONFIGS:
        _, opt, flat = STEP_CONFIGS[name]
        cfg = _step_cfg(name, num_layers=SMALL_LAYERS)
        for level, lim in STEP_LIMITS.items():
            out[_key(name, level) + " dropout"] = _train_small_one(
                dev, cfg, opt, flat, level, lim, name, dropout=True)
    return out


def lamb_master_limit(prev, state_d, state_c):
    """{leaf: per-element limit on |master_card - master_cpu|} (a tree
    like ``prev``) after the first flat FusedLAMB step from master
    ``prev`` on both, the card's state ``state_d`` and the CPU's
    ``state_c`` (the model above)."""
    from apex_tpu_torch.multi_tensor_apply.flatten import (
        make_spec, unflatten_tensors,
    )
    from apex_tpu_torch.utils.tree import tree_flatten, tree_unflatten

    leaves, treedef = tree_flatten(prev)
    spec = make_spec(leaves)
    # step 1's bias corrections as the kernel has them, in fp32
    c1 = float(1.0 - torch.tensor(0.9))
    c2 = float(1.0 - torch.tensor(0.999))
    bf = 2.0 ** -8 if state_c.m.dtype == torch.bfloat16 else 0.0
    sides = []
    for st in (state_d, state_c):
        steps = []
        for p, m, v in zip(leaves,
                           unflatten_tensors(st.m.cpu(), spec, False),
                           unflatten_tensors(st.v.cpu(), spec, False)):
            p = p.cpu().double()
            u = (m.double() / c1) / (torch.sqrt(v.double() / c2)
                                     + LAMB_EPS) + LAMB_WD * p
            wn, un = float(p.norm()), float(u.norm())
            r = wn / un if wn > 0 and un > 0 else 1.0
            steps.append((p - LAMB_LR * r * u, LAMB_LR * r * u.abs()))
        sides.append(steps)
    lims = []
    for p, (pd, sd), (pc, sc) in zip(leaves, *sides):
        k = -(-max(p.numel(), 1) // 1024) + 32   # + the buffer's tail
        rel = (1024 + k + 3 + 16 + 2) * U32 + bf
        lims.append((pd - pc).abs() + (sd + sc) * rel
                    + 2 * U32 * (pd.abs() + pc.abs()))
    return tree_unflatten(treedef, lims)


def _share(got, want, lim):
    """The largest |got - want| / lim; an element with a zero limit must
    be equal (it counts 0 then, inf else)."""
    d = (got.to(want.device).double() - want.double()).abs()
    return float(torch.where(d <= lim, d / lim.clamp_min(1e-300),
                             torch.full_like(d, float("inf"))).max())


def _train_small_one(dev, cfg, opt, flat, level, lim, name, dropout=False):
    from apex_tpu_torch.examples.bert.train import make_bert_train_step
    from apex_tpu_torch.utils.tree import tree_leaves, tree_map

    p = kernel_modules()[6]
    key = p.PRNGKey(DROPOUT_SEED) if dropout else None
    with_drop = (f", dropout {cfg.hidden_dropout} on PRNGKey("
                 f"{DROPOUT_SEED})") if dropout else ""
    phase(f"training ({name}): BERT-Large width, {SMALL_LAYERS} layers, "
          f"batch {SMALL_BATCH}, seq {SEQ}, {level}{with_drop}: one step on "
          "the card (kernels) vs the same step on the CPU (plain versions)")
    step_d, make_state, (ids, mask) = make_bert_train_step(
        SMALL_BATCH, SEQ, cfg, device=dev, opt_level=level,
        use_flat_kernel=flat, optimizer=opt, dropout_rng=key)
    state_d = list(make_state())
    step_c, _, (ids_c, mask_c) = make_bert_train_step(
        SMALL_BATCH, SEQ, cfg, device="cpu", opt_level=level,
        use_flat_kernel=flat, optimizer=opt, dropout_rng=key)
    # the step's first call draws on fold_in(key, 0): so do its gradients
    key0 = None if key is None else p.fold_in(key, 0)
    master_c = tree_map(lambda t: t.cpu(), state_d[0])
    state_c = [master_c, step_c.opt.init(master_c),
               step_c.amp.init_state("cpu")]
    check(torch.equal(ids.cpu(), ids_c), "same ids on both devices")
    t0 = time.perf_counter()
    _, _, grads_d, found_d, _ = step_d.grads(state_d[0], state_d[2],
                                             ids, mask, dropout_rng=key0)
    new_d = step_d(*state_d, ids, mask)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    _, _, grads_c, found_c, _ = step_c.grads(state_c[0], state_c[2],
                                             ids_c, mask_c, dropout_rng=key0)
    new_c = step_c(*state_c, ids_c, mask_c)
    t2 = time.perf_counter()
    loss_d, loss_c = float(new_d[-1]), float(new_c[-1])
    got = {
        "loss": abs(loss_d - loss_c) / abs(loss_c),
        "grads": _relnorm(grads_d, grads_c),
        "m": _relnorm(new_d[1].m, new_c[1].m),
        "v": _relnorm(new_d[1].v, new_c[1].v),
        "master": _maxabs(new_d[0], new_c[0]),
    }
    if opt == "lamb":   # the share of the per-element model used
        lims = lamb_master_limit(master_c, new_d[1], new_c[1])
        got["master_share"] = max(
            _share(g, w, l) for g, w, l in zip(
                tree_leaves(new_d[0]), tree_leaves(new_c[0]),
                tree_leaves(lims)))
        # master: the largest of the per-element limits
        lim = dict(lim, master_share=1.0, master=max(
            float(l.max()) for l in tree_leaves(lims)))
    print(f"card {t1 - t0:.2f} s, CPU {t2 - t1:.2f} s; loss card "
          f"{loss_d:.6f}, CPU {loss_c:.6f}", flush=True)
    check(not bool(found_d) and not bool(found_c)
          and float(new_d[2].loss_scale) == float(new_c[2].loss_scale)
          and int(new_d[2].unskipped) == int(new_c[2].unskipped) == 1
          and int(new_d[1].step) == int(new_c[1].step) == 1,
          "found_inf False on both; scaler states and step counts equal")
    for key, val in got.items():
        what = {"master": "max abs", "master_share": "share of "
                "lamb_master_limit"}.get(key, "relative")
        # the share sits just under 1 by construction: print it in full
        shown = f"{val:.7f}" if key == "master_share" else f"{val:.3g}"
        check(val <= lim[key], f"{level} {key}: card vs CPU {what} "
              f"{shown} <= {lim[key]:g}")
    del state_d, new_d, grads_d
    torch.cuda.empty_cache()
    return got


def per_step_launches(name, L, dropout=False):
    """Exact launches of each kernel in one BERT step of ``L`` layers:
    with dropout, the dropout kernel once forward and once backward (the
    backward regenerates the mask) on the embeddings and each layer's
    attention output, and in the unfused attention on each layer's
    probabilities too; the bits kernel never (the flash seed is drawn on
    the host)."""
    flash, opt, flat = STEP_CONFIGS[name]
    out = dict.fromkeys(KERNEL_NAMES, 0)
    out.update(layer_norm_fwd=2 * L + 2, layer_norm_bwd=2 * L + 2,
               xentropy_fwd=1, xentropy_bwd=1)
    if flash:
        out.update(flash_attention_fwd=L, flash_attention_bwd_dq=L,
                   flash_attention_bwd_dkv=L)
    else:
        out.update(scaled_masked_softmax_fwd=L, fused_softmax_bwd=L)
    if flat and opt == "adam":
        out.update(flat_adam=1)
    elif flat:
        out.update(flat_l2norm_partials=1, flat_lamb_stage1=1)
    if dropout:
        out.update(threefry_dropout=2 * (L + 1) if flash else 2 * (2 * L + 1))
    return out


def train_big(dev, kern):
    """Six O2 steps of full BERT-Large at the headline's shape in each
    configuration and optimizer-state mode; ``kern`` maps names to the
    kernels counted."""
    from apex_tpu_torch.examples.bert.train import STATE_MODES

    out = {}
    for name in STEP_CONFIGS:
        for mode, (m_dtype, emit) in STATE_MODES.items():
            out[_key(name, mode)] = _train_big_one(dev, kern, name, mode,
                                                   m_dtype, emit)
    out["fp32 dropout"] = _train_big_one(dev, kern, "flash_tree", "fp32",
                                         *STATE_MODES["fp32"], dropout=True)
    return out


def _train_big_one(dev, kern, name, mode, m_dtype, emit, dropout=False):
    from apex_tpu_torch.examples.bert.train import make_bert_train_step
    from apex_tpu_torch.utils.tree import tree_leaves

    cfg = _step_cfg(name)
    L = cfg.num_layers
    per_step = per_step_launches(name, L, dropout)
    with_drop = (f", hidden and attention dropout {cfg.hidden_dropout} on "
                 f"fold_in(PRNGKey({DROPOUT_SEED}), step)") if dropout else ""
    phase(f"training ({name}): BERT-Large ({L} layers), O2 dynamic loss "
          f"scale, batch {BIG_BATCH}, seq {SEQ}, {BIG_STEPS} steps, "
          f"state mode {mode}{with_drop}")
    _, opt, flat = STEP_CONFIGS[name]
    key = kernel_modules()[6].PRNGKey(DROPOUT_SEED) if dropout else None
    step, make_state, (ids, mask) = make_bert_train_step(
        BIG_BATCH, SEQ, cfg, m_dtype=m_dtype, emit_compute=emit,
        device=dev, use_flat_kernel=flat, optimizer=opt, dropout_rng=key)
    state = list(make_state())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in kern.values():
        k.launches = 0
    losses, times, steps_ok = [], [], True
    for _ in range(BIG_STEPS):
        before = {n: k.launches for n, k in kern.items()}
        t0 = time.perf_counter()
        *state, loss = step(*state, ids, mask)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(loss)
        steps_ok &= all(kern[n].launches - before[n] == per_step[n]
                        for n in kern)
    launches = {n: k.launches for n, k in kern.items()}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = [float(l) for l in losses]
    sc = state[2]
    print(f"losses {[round(l, 5) for l in losses]}", flush=True)
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          "every loss finite, the last below the first")
    check(int(sc.unskipped) == BIG_STEPS and int(sc.overflows) == 0,
          f"found_inf False on every step: scaler unskipped "
          f"{int(sc.unskipped)} == {BIG_STEPS}, overflows "
          f"{int(sc.overflows)}, loss scale {float(sc.loss_scale):g}")
    check(steps_ok and all(launches[n] == BIG_STEPS * per_step[n]
                           for n in kern),
          f"launches per step exactly {per_step} ({launches} over "
          f"{BIG_STEPS} steps)")
    if dropout:
        print(f"threefry dropout launches a step: "
              f"{launches['threefry_dropout'] / BIG_STEPS:g} (bits "
              f"{launches['threefry_bits'] / BIG_STEPS:g})", flush=True)
    if emit:
        m_ok = all(t.dtype == torch.bfloat16
                   for t in tree_leaves(state[1].m))
        cast = step.amp.cast_model(state[0])
        c_ok = all(c.dtype == w.dtype and torch.equal(c, w) for c, w in
                   zip(tree_leaves(state[3]), tree_leaves(cast)))
        check(m_ok and c_ok, "m leaves bf16; emitted compute tree "
              "array-equal to cast_model(master)")
    med = statistics.median(times[1:])
    print(f"smoke reading, not a benchmark: median step "
          f"{med * 1e3:.1f} ms over steps 2-{BIG_STEPS} "
          f"({BIG_BATCH / med:.1f} samples/s); first step "
          f"{times[0] * 1e3:.1f} ms; peak device memory {peak:.2f} GiB",
          flush=True)
    res = dict(losses=losses, step_ms=[t * 1e3 for t in times],
               median_step_ms=med * 1e3, samples_per_s=BIG_BATCH / med,
               launches=launches, peak_gib=peak)
    del state, step
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# 5. the SGD-family optimizers on BERT-Large's parameter set
# ---------------------------------------------------------------------------

OPT_STEPS = 3
# name -> (constructor arguments, kernel launches per flat step); the
# cases of the JAX package's own tests (weight decay 0.01; SGD with the
# imagenet example's momentum and weight decay)
OPT_CASES = {
    "FusedSGD": (dict(lr=0.1, momentum=0.9, weight_decay=1e-4),
                 {"flat_sgd": 1}),
    "FusedAdagrad": (dict(lr=1e-2, weight_decay=0.01), {"flat_adagrad": 1}),
    "FusedNovoGrad": (dict(lr=1e-3, weight_decay=0.01),
                      {"flat_novograd": 1, "flat_l2norm_partials": 1}),
}


def _novograd_model(model, leaves_p, leaves_g, m_tree, v_tree, t, kw):
    """Advance NovoGrad's flat-vs-tree error model by step ``t`` (per
    element, float64, from the tree path's values): the per-tensor
    ||g||^2 is a sum in another order on each path (partials and span
    sums against ``torch.sum``), within r = 2 (n + 1) u of it (n the
    tensor's padded elements); v's difference D follows v's EMA; the
    denominator's relative difference is D / (2 v) + 8 u; m's difference
    M = b1 M + beta3 |g| / denom (that, + 4 u) + 4 u of m's terms; p's P
    = P + lr (M / c1 + 4 u (|m| / c1 + wd |p|)) + 2 u |p|. Returns the
    per-leaf (P, M, D) lists."""
    b1, b2 = NOVO_BETAS
    lr, wd = kw["lr"], kw["weight_decay"]
    beta3 = 1.0 - b1
    c1, c2 = 1.0 - b1 ** t, 1.0 - b2 ** t
    u32 = U32
    out = []
    for i, (p, g, m, v) in enumerate(zip(leaves_p, leaves_g, m_tree,
                                         v_tree)):
        P, M, D = model[i] if model else (0.0, 0.0, 0.0)
        g, p, m = g.double(), p.double(), m.double()
        n = (-(-max(g.numel(), 1) // 1024)) * 1024
        gsq = float((g * g).sum())
        r = 2.0 * (n + 1) * u32
        D = r * gsq if t == 1 else b2 * D + (1.0 - b2) * r * gsq
        vv = float(v)
        den = (vv / c2) ** 0.5 + NOVO_EPS
        e = D / (2.0 * max(vv, 1e-300)) + 8 * u32
        gn = g.abs() / den
        M = b1 * M + beta3 * gn * (e + 4 * u32) + 4 * u32 * (
            b1 * m.abs() + beta3 * gn)
        P = P + lr * (M / c1 + 4 * u32 * (m.abs() / c1 + wd * p.abs())) \
            + 2 * u32 * p.abs()
        out.append((P, M, D + 4 * u32 * vv))
    return out


def opt_steps(dev, kern):
    """Three flat steps of FusedSGD, FusedAdagrad and FusedNovoGrad on
    the full BERT-Large fp32 tree, with seeded synthetic gradients, each
    against the same optimizer's tree path on the card: SGD and Adagrad
    bit for bit (their kernels take the tree path's fp32 operations: g * 1
    and (1 - 0) * wd are exact, and the skipped terms add 0), NovoGrad to
    its error model (``_novograd_model``); exact launches a step."""
    from apex_tpu_torch import optimizers
    from apex_tpu_torch.models.bert import bert_large, init_bert
    from apex_tpu_torch.multi_tensor_apply.flatten import (
        make_spec, unflatten_tensors,
    )
    from apex_tpu_torch.utils.tree import tree_flatten, tree_map

    params = init_bert(bert_large(), torch.Generator(device=dev).manual_seed(
        0), device=dev)
    spec = make_spec(tree_flatten(params)[0])
    out = {}
    for name, (kw, per_step) in OPT_CASES.items():
        phase(f"optimizer steps: {name}({kw}) on BERT-Large's parameter set "
              f"({spec.num_tensors} tensors), {OPT_STEPS} flat steps "
              "(use_flat_kernel=True) against the tree path on the card "
              "(tolerance: SGD and Adagrad bit for bit; NovoGrad per element "
              "to its flat-vs-tree error model)")
        cls = getattr(optimizers, name)
        flat, tree = cls(use_flat_kernel=True, **kw), cls(**kw)
        pf, sf = params, flat.init(params)
        pt, st = params, tree.init(params)
        want = {n: per_step.get(n, 0) for n in kern}
        for k in kern.values():
            k.launches = 0
        gen = torch.Generator(device=dev).manual_seed(100)
        model, times_f, shares = None, [], []
        for t in range(1, OPT_STEPS + 1):
            grads = tree_map(lambda x: torch.randn(
                x.shape, generator=gen, device=dev) * 1e-3, params)
            before = {n: k.launches for n, k in kern.items()}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            prev_t = pt
            pf, sf = flat.step(grads, pf, sf)
            torch.cuda.synchronize()
            times_f.append(time.perf_counter() - t0)
            step_l = {n: kern[n].launches - before[n] for n in kern}
            pt, st = tree.step(grads, pt, st)
            torch.cuda.synchronize()
            got = {n: c for n, c in step_l.items() if c}
            check(step_l == want and int(sf.step) == int(st.step) == t,
                  f"{name} step {t}: launches {got} (exactly {per_step}); "
                  f"step counts {int(sf.step)}")
            lf, lt = tree_flatten(pf)[0], tree_flatten(pt)[0]
            if name == "FusedNovoGrad":
                mf = unflatten_tensors(sf.m, spec, cast_back=False)
                mt, vt = tree_flatten(st.m)[0], tree_flatten(st.v)[0]
                model = _novograd_model(model, tree_flatten(prev_t)[0],
                                        tree_flatten(grads)[0], mt, vt, t,
                                        kw)
                share = max(max(_share(a, b, P), _share(c, d, M))
                            for a, b, c, d, (P, M, _) in zip(
                                lf, lt, mf, mt, model))
                vs = max(abs(float(sf.v[i]) - float(v)) / D
                         for i, (v, (_, _, D)) in enumerate(zip(vt, model)))
                share = max(share, vs)
                shares.append(share)
                check(share <= 1.0, f"{name} step {t}: flat p, m and v "
                      f"against the tree path, {share:.4f} of the model")
            else:
                state_f = sf[1]
                leaves_s = unflatten_tensors(state_f, spec, cast_back=False)
                same = all(torch.equal(a, b) for a, b in zip(lf, lt)) and \
                    all(torch.equal(a, b) for a, b in zip(
                        leaves_s, tree_flatten(st[1])[0]))
                err = max(float((a - b).abs().max()) for a, b in zip(lf, lt))
                shares.append(err)
                check(same, f"{name} step {t}: flat params and "
                      f"{sf._fields[1]} bit-equal to the tree path's "
                      f"(max_abs_err {err:.3g})")
            del grads, prev_t
        moved = max(float((a - b).abs().max()) for a, b in zip(
            tree_flatten(pf)[0], tree_flatten(params)[0]))
        check(moved > 0, f"{name}: the params moved (max |dp| {moved:.3g})")
        out[name] = dict(launches={n: k.launches for n, k in kern.items()
                                   if k.launches},
                         flat_step_ms=[x * 1e3 for x in times_f],
                         worst=max(shares))
        print(f"{name}: flat step {statistics.median(times_f) * 1e3:.1f} ms "
              f"(host clock, synchronised; median of {OPT_STEPS})", flush=True)
        del pf, sf, pt, st, flat, tree
        torch.cuda.empty_cache()
    del params
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# 6. ResNet-50 training (examples/imagenet/main_amp.py)
# ---------------------------------------------------------------------------

RESNET_DEPTH, RESNET_CLASSES = 50, 1000
RESNET_SMALL = (4, 64)     # batch, image size of the card-vs-CPU step
RESNET_BIG = (64, 224)     # the JAX example's defaults
RESNET_STEPS = 6
# The six steps run at lr 0.025, the JAX example's 0.1 scaled to batch 64
# by the reference apex example's rule (lr * batch / 256). At 0.1 on one
# fixed batch this phase's losses diverge from the third step (on an
# H100: 7.46, 5.52, 7.66, 11.18, 14.28, 14.98), so "the last below the
# first" would test the learning rate, not the step.
RESNET_BIG_LR = 0.025
# Card vs CPU. This random-init ResNet-50 amplifies rounding into its
# gradients so much that no fp32 result, card or CPU, is within BERT's
# 1e-4 of another: the float64 step below puts the CPU's own fp32
# gradients about three quarters of a percent from it (relative norm;
# this phase prints each device's distance). Each device's loss,
# gradients and new statistics are held instead to that float64 step:
# the card's distance from it at most RESNET_FACTOR[level] times the
# CPU's, plus 64 u (a floor for a CPU that lands close by chance). fp32:
# 4, because cuDNN may pick convolution algorithms (Winograd, FFT) that
# round more than a direct sum, while a wrong path (a padding shift, a
# missing term) lands at O(1). O2: bf16 rounding of every activation puts
# a large share of the gradient's norm in noise on either device (on
# ResNet-10, about a fifth for JAX and the port alike:
# tests/test_torch_resnet_train.py prints both), the same on both, so
# 1.5. Master and momentum buffer are held per element to the SGD model
# (``sgd_master_limit``). The card-vs-CPU differences are printed beside.
RESNET_FACTOR = {"O0": 4.0, "O2": 1.5}


def _sgd_first_step(p, g, lr, wd):
    """FusedSGD's first step with momentum, in float64: the buffer is
    seeded with d = g + wd p, and p - lr d."""
    d = g.double() + wd * p.double()
    return p.double() - lr * d, d


def sgd_master_limit(p, g_d, g_c, lr, wd):
    """(limit on |master_card - master_cpu|, on |buf_card - buf_cpu|)
    after FusedSGD's first momentum step from master ``p``: each side's
    step recomputed in float64 from its own gradient, the two results'
    difference plus each side's fp32 roundings (d = g + wd p: 2 u of its
    terms; p - lr d: u of lr |d| and u of |p_new|)."""
    pd, dd = _sgd_first_step(p, g_d, lr, wd)
    pc, dc = _sgd_first_step(p, g_c, lr, wd)
    terms = g_d.double().abs() + g_c.double().abs() + 2 * wd * p.double(
    ).abs()
    buf = (dd - dc).abs() + 2 * U32 * terms
    master = (pd - pc).abs() + lr * (3 * U32 * terms + buf) \
        + 2 * U32 * (pd.abs() + pc.abs())
    return master, buf


def _rel_global(got, want):
    """||got - want|| / ||want|| over all leaves together (float64, CPU)."""
    from apex_tpu_torch.utils.tree import tree_flatten

    num = den = 0.0
    for a, b in zip(tree_flatten(got)[0], tree_flatten(want)[0]):
        a, b = a.detach().cpu().double(), b.detach().cpu().double()
        num += float(((a - b) ** 2).sum())
        den += float((b ** 2).sum())
    return (num / den) ** 0.5


def resnet_small(dev):
    """One step of each configuration, ResNet-50 at full width and depth,
    batch 4, 64 x 64, on the card (kernels) and on the CPU (plain
    versions) from the same weights and batch. The gradient half runs
    once per opt level on each device (the two O0 configurations share
    it); each configuration then takes its own optimizer step."""
    from apex_tpu_torch.examples.imagenet.main_amp import (
        CONFIGS, LR, MOMENTUM, WEIGHT_DECAY, make_resnet_train_step,
        synthetic_batch,
    )
    from apex_tpu_torch.models.resnet import init_resnet
    from apex_tpu_torch.optimizers import FusedSGD
    from apex_tpu_torch.utils.tree import tree_flatten, tree_map

    batch, size = RESNET_SMALL
    phase(f"ResNet training, card vs CPU: ResNet-{RESNET_DEPTH}, "
          f"{RESNET_CLASSES} classes, batch {batch}, {size} x {size}: one "
          "step of each configuration on the card (kernels) against the "
          "same step on the CPU (plain versions)")
    params, stats = init_resnet(torch.Generator(device=dev).manual_seed(0),
                                RESNET_DEPTH, RESNET_CLASSES, device=dev)
    cpu = lambda tree: tree_map(lambda t: t.cpu(), tree)  # noqa: E731
    params_c, stats_c = cpu(params), cpu(stats)
    images, labels = synthetic_batch(0, batch, size, RESNET_CLASSES, dev)
    images_c, labels_c = images.cpu(), labels.cpu()
    t0 = time.perf_counter()
    ref = make_resnet_train_step(RESNET_DEPTH, "O0")
    f64 = lambda tree: tree_map(lambda t: t.double(), tree)  # noqa: E731
    (loss64, ns64), g64, _, _ = ref.amp.value_and_grad(
        ref.loss_fn, has_aux=True)(f64(params_c), ref.amp.init_state("cpu"),
                                   f64(stats_c), images_c.double(), labels_c)
    print(f"float64 reference step on the CPU in "
          f"{time.perf_counter() - t0:.2f} s; loss {float(loss64):.9f}",
          flush=True)
    out, halves = {}, {}
    for name, (level, flat) in CONFIGS.items():
        mk = lambda: FusedSGD(lr=LR, momentum=MOMENTUM,  # noqa: E731
                              weight_decay=WEIGHT_DECAY,
                              use_flat_kernel=flat)
        step_d = make_resnet_train_step(RESNET_DEPTH, level, optimizer=mk())
        step_c = make_resnet_train_step(RESNET_DEPTH, level, optimizer=mk())
        st_d = step_d.init_state(params, stats, dev)
        st_c = step_c.init_state(params_c, stats_c, "cpu")
        if level not in halves:
            t0 = time.perf_counter()
            hd = step_d.grads(st_d[0], st_d[1], st_d[3], images, labels)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            hc = step_c.grads(st_c[0], st_c[1], st_c[3], images_c, labels_c)
            t2 = time.perf_counter()
            halves[level] = (hd, hc)
            print(f"{level} gradient half: card {t1 - t0:.2f} s, CPU "
                  f"{t2 - t1:.2f} s; loss card {float(hd[0]):.6f}, CPU "
                  f"{float(hc[0]):.6f}", flush=True)
        (loss_d, ns_d, g_d, f_d, sc_d), (loss_c, ns_c, g_c, f_c, sc_c) = \
            halves[level]
        check(not bool(f_d) and not bool(f_c), f"{name}: found_inf False "
              "on both")
        m_d, o_d = step_d.opt.step(g_d, st_d[0], st_d[2], found_inf=f_d)
        m_c, o_c = step_c.opt.step(g_c, st_c[0], st_c[2], found_inf=f_c)
        torch.cuda.synchronize()
        res = {}
        for key, card, cpu, want in (
                ("loss", {"l": loss_d}, {"l": loss_c}, {"l": loss64}),
                ("grads", g_d, g_c, g64), ("stats", ns_d, ns_c, ns64)):
            if level == "O2" and key == "stats":
                continue   # bf16 activations: the statistics of another input
            d_card, d_cpu = _rel_global(card, want), _rel_global(cpu, want)
            res[key] = dict(card_vs_f64=d_card, cpu_vs_f64=d_cpu,
                            card_vs_cpu=_rel_global(card, cpu))
            check(d_card <= RESNET_FACTOR[level] * d_cpu + 64 * U32,
                  f"{name} {level} {key}: card {d_card:.3g} from the float64 "
                  f"step (relative norm), CPU {d_cpu:.3g}; card vs CPU "
                  f"{res[key]['card_vs_cpu']:.3g} (for information)")
        if level == "O0":
            from apex_tpu_torch.multi_tensor_apply.flatten import (
                make_spec, unflatten_tensors,
            )
            spec = make_spec(tree_flatten(params_c)[0])
            bufs_d = tree_flatten(o_d.momentum_buf)[0] if not flat else \
                unflatten_tensors(o_d.momentum_buf.cpu(), spec, False)
            bufs_c = tree_flatten(o_c.momentum_buf)[0] if not flat else \
                unflatten_tensors(o_c.momentum_buf, spec, False)
            share_m = share_b = 0.0
            for p, gd, gc, md, mc, bd, bc in zip(
                    tree_flatten(params_c)[0], tree_flatten(g_d)[0],
                    tree_flatten(g_c)[0], tree_flatten(m_d)[0],
                    tree_flatten(m_c)[0], bufs_d, bufs_c):
                lim_m, lim_b = sgd_master_limit(p, gd.cpu(), gc, LR,
                                                WEIGHT_DECAY)
                share_m = max(share_m, _share(md, mc, lim_m))
                share_b = max(share_b, _share(bd, bc, lim_b))
            res.update(master_share=share_m, buf_share=share_b)
            check(share_m <= 1.0 and share_b <= 1.0, f"{name} O0 master "
                  f"and momentum buffer per element: {share_m:.4f} and "
                  f"{share_b:.4f} of sgd_master_limit")
        else:
            finite = all(bool(torch.isfinite(t).all()) and t.dtype ==
                         torch.float32 for t in tree_flatten(m_d)[0])
            check(finite, f"{name}: fp32 master finite after the step")
        out[name] = res
        del step_d, step_c, st_d, st_c, m_d, m_c, o_d, o_c
    del halves, params, stats, g64, ns64
    torch.cuda.empty_cache()
    return out


def resnet_big(dev, kern):
    """Six steps of each configuration at the JAX example's size on one
    fixed synthetic batch through the example's step, counts set to 0
    before each run and read after it."""
    from apex_tpu_torch.examples.imagenet.main_amp import (
        CONFIGS, MOMENTUM, WEIGHT_DECAY, make_resnet_train_step,
        synthetic_batch,
    )
    from apex_tpu_torch.models.resnet import init_resnet
    from apex_tpu_torch.optimizers import FusedSGD

    batch, size = RESNET_BIG
    images, labels = synthetic_batch(0, batch, size, RESNET_CLASSES, dev)
    out = {}
    for name, (level, flat) in CONFIGS.items():
        phase(f"ResNet training ({name}): ResNet-{RESNET_DEPTH}, "
              f"{RESNET_CLASSES} classes, amp {level}, FusedSGD(lr="
              f"{RESNET_BIG_LR}, momentum={MOMENTUM}, weight_decay="
              f"{WEIGHT_DECAY}, use_flat_kernel={flat}), batch {batch}, "
              f"{size} x {size}, {RESNET_STEPS} steps on one fixed batch")
        step = make_resnet_train_step(RESNET_DEPTH, level, optimizer=FusedSGD(
            lr=RESNET_BIG_LR, momentum=MOMENTUM, weight_decay=WEIGHT_DECAY,
            use_flat_kernel=flat))
        params, stats = init_resnet(
            torch.Generator(device=dev).manual_seed(0), RESNET_DEPTH,
            RESNET_CLASSES, device=dev)
        state = list(step.init_state(params, stats, dev))
        del params, stats
        per_step = {n: 0 for n in kern}
        if flat:
            per_step["flat_sgd"] = 1
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for k in kern.values():
            k.launches = 0
        losses, times, steps_ok = [], [], True
        for _ in range(RESNET_STEPS):
            before = {n: k.launches for n, k in kern.items()}
            t0 = time.perf_counter()
            *state, loss = step(*state, images, labels)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            losses.append(loss)
            steps_ok &= all(kern[n].launches - before[n] == per_step[n]
                            for n in kern)
        launches = {n: k.launches for n, k in kern.items()}
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        losses = [float(l) for l in losses]
        sc = state[3]
        print(f"losses {[round(l, 5) for l in losses]}", flush=True)
        check(all(np.isfinite(losses)) and losses[-1] < losses[0],
              "every loss finite, the last below the first")
        print(f"overflows (found_inf True): {int(sc.overflows)}; loss scale "
              f"{float(sc.loss_scale):g}", flush=True)
        check(steps_ok and all(launches[n] == RESNET_STEPS * per_step[n]
                               for n in kern),
              f"launches per step exactly "
              f"{({n: c for n, c in per_step.items() if c})} (every other "
              f"kernel 0; {({n: c for n, c in launches.items() if c})} over "
              f"{RESNET_STEPS} steps)")
        med = statistics.median(times[1:])
        print(f"smoke reading, not a benchmark: median step "
              f"{med * 1e3:.1f} ms over steps 2-{RESNET_STEPS} "
              f"({batch / med:.1f} img/s); first step "
              f"{times[0] * 1e3:.1f} ms; peak device memory {peak:.2f} GiB",
              flush=True)
        out[name] = dict(losses=losses, step_ms=[t * 1e3 for t in times],
                         median_step_ms=med * 1e3, img_per_s=batch / med,
                         overflows=int(sc.overflows), launches=launches,
                         peak_gib=peak)
        del state, step
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# 7. times
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
    ln, fa = kernel_modules()[:2]
    phase("times at the serving path's shapes (device ms per call; "
          "medians of CUDA-graph replays timed with CUDA events)")
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
        # what the serving prefill launches: _split_qkv views of the fused
        # projection, with the bucket's key mask
        from apex_tpu_torch.models.gpt import _split_qkv

        qv, kv_, vv = _split_qkv(_rand(gen, (b_, s, 3 * h_ * d),
                                       torch.bfloat16, dev), d)
        mask = torch.ones((b_, s), dtype=torch.int32, device=dev)
        _entry(res, "flash_b1h16s1024d64_gpt_views",
               time_ms(lambda: fa.attention_fwd_kernel(
                   qv, kv_, vv, mask, (0, 0), **kw)),
               time_ms(lambda: fa.attention_fwd_plain(
                   qv, kv_, vv, mask, (0, 0), **kw)),
               time_ms(lambda: F.scaled_dot_product_attention(
                   qv, kv_, vv, is_causal=True, scale=d ** -0.5)),
               nbytes + b_ * s * 4, 4 * d * pairs * b_ * h_, BF16_TC_FLOPS,
               "flash b1 h16 s1024 d64 causal bf16, GPT _split_qkv views "
               f"({_load_variant(qv, kv_, vv)})",
               "scaled_dot_product_attention")
    return res


def _entry(res, key, t_k, t_p, t_l, nbytes, flops, peak, label, lib):
    bd, by = bound(nbytes, flops, peak)
    res[key] = dict(ms=t_k, plain_ms=t_p, library_ms=t_l, bound_ms=bd,
                    bound_by=by)
    lib_ms = "" if t_l is None else f" {t_l:.5f}"
    print(f"{label}: kernel {t_k:.5f}, plain {t_p:.5f}, {lib}{lib_ms}, "
          f"bound {bd:.5f} ({by})", flush=True)


def train_times(dev):
    """The training path's kernels at the BERT-Large O2 step's shapes.
    Library calls needing autograd are timed as forward + backward minus
    forward; every call, autograd included, is captured in the graph."""
    ln, fa, xent = kernel_modules()[:3]
    phase("times at the training path's shapes (BERT-Large, batch 64, "
          "seq 128; device ms per call, CUDA-graph replays)")
    gen = torch.Generator(device=dev).manual_seed(7)
    bf, f32 = torch.bfloat16, torch.float32
    res = {}
    rows, h = BIG_BATCH * SEQ, 1024
    x = _rand(gen, (rows, h), bf, dev)
    dy = _rand(gen, (rows, h), bf, dev)
    w = _rand(gen, (h,), f32, dev, 0.5, 1.0)
    b = _rand(gen, (h,), f32, dev, 0.3)
    _, mean, rstd = ln.layer_norm_fwd_plain(x, w, b, "ln", 1e-12)
    w16, b16 = w.to(bf), b.to(bf)
    _entry(res, "ln_fwd_train",
           time_ms(lambda: ln.layer_norm_fwd_kernel(x, w, b, "ln", 1e-12)),
           time_ms(lambda: ln.layer_norm_fwd_plain(x, w, b, "ln", 1e-12)),
           time_ms(lambda: F.layer_norm(x, (h,), w16, b16, 1e-12)),
           2 * rows * h * 2 + 2 * h * 4 + 2 * rows * 4, 8 * rows * h,
           FP32_FLOPS, f"LN fwd ({rows}, {h}) bf16 x, fp32 w, b",
           "F.layer_norm (bf16 w, b)")
    _entry(res, "ln_bwd",
           time_ms(lambda: ln.layer_norm_bwd_kernel(dy, x, w, b, mean, rstd)),
           time_ms(lambda: ln.layer_norm_bwd_plain(dy, x, w, b, mean, rstd)),
           time_ms(lambda: torch.ops.aten.native_layer_norm_backward(
               dy, x, [h], mean, rstd, w16, b16, [True, True, True])),
           3 * rows * h * 2 + h * 4 + 2 * rows * 4 + 2 * h * 4,
           12 * rows * h, FP32_FLOPS,
           f"LN bwd ({rows}, {h}) bf16 x, fp32 w, b",
           "native_layer_norm_backward (bf16 w, b)")
    # the regime where the JAX package splits columns (h >= 2731)
    r4, h4 = 2048, 4096
    x4, dy4 = _rand(gen, (r4, h4), bf, dev), _rand(gen, (r4, h4), bf, dev)
    w4, b4 = _rand(gen, (h4,), f32, dev, 0.5, 1.0), _rand(gen, (h4,), f32,
                                                          dev, 0.3)
    _, mean4, rstd4 = ln.layer_norm_fwd_plain(x4, w4, b4, "ln", 1e-12)
    _entry(res, "ln_bwd_4096",
           time_ms(lambda: ln.layer_norm_bwd_kernel(dy4, x4, w4, b4, mean4,
                                                    rstd4)),
           time_ms(lambda: ln.layer_norm_bwd_plain(dy4, x4, w4, b4, mean4,
                                                   rstd4)),
           time_ms(lambda: torch.ops.aten.native_layer_norm_backward(
               dy4, x4, [h4], mean4, rstd4, w4.to(bf), b4.to(bf),
               [True, True, True])),
           3 * r4 * h4 * 2 + h4 * 4 + 2 * r4 * 4 + 2 * h4 * 4,
           12 * r4 * h4, FP32_FLOPS,
           f"LN bwd ({r4}, {h4}) bf16 x, fp32 w, b (JAX column split)",
           "native_layer_norm_backward (bf16 w, b)")

    bb, hh, s, d = BIG_BATCH, 16, SEQ, 64
    qkv = _rand(gen, (bb, s, 3, hh, d), bf, dev)
    q, k, v = (qkv[:, :, j].transpose(1, 2) for j in range(3))
    do = _rand(gen, (bb, hh, s, d), bf, dev)
    mask = torch.ones((bb, s), dtype=torch.int32, device=dev)  # the step's
    kw = dict(causal=False, scale=d ** -0.5, rate=0.0)
    o, lse = fa.attention_fwd_kernel(q, k, v, mask, (0, 0), **kw)
    delta = (do.float() * o.float()).sum(-1).reshape(-1, s)
    qc, kc, vc = (t.contiguous().requires_grad_(True) for t in (q, k, v))

    def sdpa():
        return F.scaled_dot_product_attention(qc, kc, vc, scale=d ** -0.5)

    t_lf = time_ms(lambda: sdpa().detach())
    t_lfb = time_ms(lambda: torch.autograd.grad(sdpa(), (qc, kc, vc), do))
    t_pb = time_ms(lambda: fa.attention_bwd_plain(q, k, v, mask, o, lse, do,
                                                  (0, 0), **kw))
    pairs = bb * hh * s * s             # no causal cut, no masked key
    qkvo = 4 * bb * hh * s * d * 2
    rowstats = 2 * bb * hh * s * 4 + bb * s * 4
    label = f"b{bb} h{hh} s{s} d{d} bf16, BERT views"
    _entry(res, "flash_fwd_train",
           time_ms(lambda: fa.attention_fwd_kernel(q, k, v, mask, (0, 0),
                                                   **kw)),
           time_ms(lambda: fa.attention_fwd_plain(q, k, v, mask, (0, 0),
                                                  **kw)),
           t_lf, qkvo + bb * hh * s * 4 + bb * s * 4, 4 * d * pairs,
           BF16_TC_FLOPS, f"flash fwd {label}",
           "scaled_dot_product_attention")
    _entry(res, "flash_dq",
           time_ms(lambda: fa.attention_dq_kernel(q, k, v, mask, do, lse,
                                                  delta, (0, 0), **kw)),
           t_pb, t_lfb - t_lf, qkvo + rowstats + bb * hh * s * d * 2,
           6 * d * pairs, BF16_TC_FLOPS, f"flash dq {label}",
           "sdpa backward (fwd+bwd - fwd; plain: whole backward)")
    _entry(res, "flash_dkv",
           time_ms(lambda: fa.attention_dkv_kernel(q, k, v, mask, do, lse,
                                                   delta, (0, 0), **kw)),
           t_pb, t_lfb - t_lf, qkvo + rowstats + 2 * bb * hh * s * d * 2,
           8 * d * pairs, BF16_TC_FLOPS, f"flash dk/dv {label}",
           "sdpa backward (fwd+bwd - fwd; plain: whole backward)")

    n, vv = rows, 30522
    logits = _rand(gen, (n, vv), f32, dev, 3.0)
    labels = torch.randint(0, vv, (n,), generator=gen, device=dev)
    dloss = torch.full((n,), 1.0 / n, device=dev)   # the mean's gradient
    _, xlse = xent.xentropy_fwd_plain(logits, labels, 0.0)
    lr = logits.clone().requires_grad_(True)

    def ce():
        return F.cross_entropy(lr, labels, reduction="none", ignore_index=-1)

    t_cf = time_ms(lambda: ce().detach(), inner=5)
    t_cfb = time_ms(lambda: torch.autograd.grad(ce(), lr, dloss), inner=5)
    _entry(res, "xent_fwd",
           time_ms(lambda: xent.xentropy_fwd_kernel(logits, labels, 0.0),
                   inner=5),
           time_ms(lambda: xent.xentropy_fwd_plain(logits, labels, 0.0),
                   inner=5),
           t_cf, n * vv * 4 + n * 8 + 2 * n * 4, 4 * n * vv, FP32_FLOPS,
           f"xentropy fwd ({n}, {vv}) fp32", "F.cross_entropy")
    _entry(res, "xent_bwd",
           time_ms(lambda: xent.xentropy_bwd_kernel(logits, labels, xlse,
                                                    dloss, 0.0), inner=5),
           time_ms(lambda: xent.xentropy_bwd_plain(logits, labels, xlse,
                                                   dloss, 0.0), inner=5),
           t_cfb - t_cf, 2 * n * vv * 4 + n * (8 + 4 + 4), 4 * n * vv,
           FP32_FLOPS, f"xentropy bwd ({n}, {vv}) fp32",
           "F.cross_entropy backward (fwd+bwd - fwd)")
    return res


def _fused_adamw(tensors, m, v, dev):
    """One ``torch._fused_adamw_`` call over the tree's tensors: the
    library call computing the flat step's function in fp32 mode, timed
    only."""
    ps, gs = tensors
    steps = [torch.full((), 3.0, device=dev) for _ in ps]
    return lambda: torch._fused_adamw_(
        ps, gs, m, v, [], steps, lr=LR, beta1=0.9, beta2=0.999,
        weight_decay=0.01, eps=1e-8, amsgrad=False, maximize=False)


def step_times(dev):
    """The unfused-attention, flat-Adam step's kernels at its shapes. No
    single PyTorch call computes the scaled, masked softmax or its
    backward, so their library time is null; the nearest calls
    (``torch.softmax`` without scale or mask, ``_softmax_backward_data``
    without the scale) are printed beside them."""
    from apex_tpu_torch.multi_tensor_apply.flatten import unflatten_tensors

    fsm, mta = kernel_modules()[3:5]
    phase("times at the unfused-attention, flat-Adam step's shapes "
          "(BERT-Large, batch 64, seq 128; device ms per call, CUDA-graph "
          "replays)")
    gen = torch.Generator(device=dev).manual_seed(10)
    bf = torch.bfloat16
    res = {}
    b, nh, s = BIG_BATCH, 16, SEQ
    x = _rand(gen, (b, nh, s, s), bf, dev, 8.0)
    dy = _rand(gen, (b, nh, s, s), bf, dev)
    mask = torch.zeros((b, 1, 1, s), dtype=torch.int32, device=dev)
    n = x.numel()
    y = fsm.masked_softmax_fwd_kernel(x, mask, SM_SCALE)
    near_f = time_ms(lambda: torch.softmax(x, -1))
    near_b = time_ms(lambda: torch._softmax_backward_data(dy, y, -1, bf))
    _entry(res, "softmax_fwd",
           time_ms(lambda: fsm.masked_softmax_fwd_kernel(x, mask, SM_SCALE)),
           time_ms(lambda: fsm.masked_softmax_fwd_plain(x, mask, SM_SCALE)),
           None, 2 * n * 2 + b * s * 4, 5 * n, FP32_FLOPS,
           f"masked softmax fwd ({b}, {nh}, {s}, {s}) bf16",
           f"no single call (torch.softmax, no scale or mask: {near_f:.5f})")
    _entry(res, "softmax_bwd",
           time_ms(lambda: fsm.softmax_bwd_kernel(y, dy, SM_SCALE)),
           time_ms(lambda: fsm.softmax_bwd_plain(y, dy, SM_SCALE)),
           None, 3 * n * 2, 5 * n, FP32_FLOPS,
           f"softmax bwd ({b}, {nh}, {s}, {s}) bf16",
           f"no single call (_softmax_backward_data, no scale: "
           f"{near_b:.5f})")
    bc, sc = 16, 1024
    xc = _rand(gen, (bc, sc, sc), bf, dev, 4.0)
    nc = xc.numel()
    _entry(res, "softmax_causal",
           time_ms(lambda: fsm.causal_softmax_fwd_kernel(xc, SM_SCALE)),
           time_ms(lambda: fsm.causal_softmax_fwd_plain(xc, SM_SCALE)),
           None, 2 * nc * 2, 5 * nc, FP32_FLOPS,
           f"causal softmax fwd ({bc}, {sc}, {sc}) bf16", "no single call")
    del x, dy, y, xc
    for m_dtype, emit, key in ((torch.float32, None, "flat_adam"),
                               (bf, bf, "flat_adam_bf16m_castout")):
        g, p, m, v, hp, spec = adam_inputs(dev, m_dtype, gen)
        nel = p.numel()
        lib = None
        if emit is None:   # the library call over the tree's tensors
            views = [unflatten_tensors(t, spec) for t in (p, g, m, v)]
            lib = time_ms(_fused_adamw(views[:2], views[2], views[3], dev),
                          reps=5, inner=3)
        nbytes = nel * (4 * 3 + 4 * 2 + 2 * m.element_size()
                        + (2 if emit else 0))
        _entry(res, key,
               time_ms(lambda: mta.flat_adam_kernel(g, p, m, v, hp, None,
                                                    emit), reps=5, inner=3),
               time_ms(lambda: mta.flat_adam_plain(g, p, m, v, hp, None,
                                                   emit), reps=5, inner=3),
               lib, nbytes, 16 * nel, FP32_FLOPS,
               f"flat_adam ({spec.total_rows}, 128) m {str(m_dtype)[6:]}"
               f"{', bf16 cast-out' if emit else ''}",
               "torch._fused_adamw_ over the tree's tensors" if emit is None
               else "none (bf16 m)")
        del g, p, m, v
        torch.cuda.empty_cache()
    return res


def flat_times(dev):
    """The four flat kernels of this slice at BERT-Large's flat buffer
    (336,232,448 elements, fp32). Library calls: for the scale,
    ``torch._amp_foreach_non_finite_check_and_unscale_`` over the 300
    tensors (in place, scale 1, so the values stay put); for the
    partials, ``torch.linalg.vector_norm`` of the flat buffer (the same
    bytes; ``torch._foreach_norm`` over the tensors printed beside it);
    none computes axpby with its flag or LAMB's stage 1."""
    from apex_tpu_torch.multi_tensor_apply.flatten import unflatten_tensors

    mta = kernel_modules()[4]
    phase("times of the flat kernels on BERT-Large's flat buffer (device "
          "ms per call, CUDA-graph replays of 3 calls)")
    gen = torch.Generator(device=dev).manual_seed(13)
    res = {}
    kw = dict(reps=5, inner=3)
    x, spec = bert_flat(dev)
    nel = x.numel()
    label = f"({spec.total_rows}, 128) fp32"
    y = _rand(gen, x.shape, torch.float32, dev, 1e-2)
    s = torch.tensor(1.0 / 65536, device=dev)
    ab = torch.tensor([0.9, 0.1], device=dev)
    leaves = unflatten_tensors(x, spec)
    found = torch.zeros((), device=dev)
    one = torch.ones((), device=dev)
    _entry(res, "flat_scale",
           time_ms(lambda: mta.flat_scale_kernel(x, s, torch.float32), **kw),
           time_ms(lambda: mta.flat_scale_plain(x, s, torch.float32), **kw),
           time_ms(lambda: torch._amp_foreach_non_finite_check_and_unscale_(
               leaves, found, one), **kw),
           8 * nel, 2 * nel, FP32_FLOPS, f"flat_scale {label}",
           "_amp_foreach_non_finite_check_and_unscale_ over the tensors")
    _entry(res, "flat_axpby",
           time_ms(lambda: mta.flat_axpby_kernel(x, y, ab, torch.float32),
                   **kw),
           time_ms(lambda: mta.flat_axpby_plain(x, y, ab, torch.float32),
                   **kw),
           None, 12 * nel, 4 * nel, FP32_FLOPS, f"flat_axpby {label}",
           "none")
    t_fn = time_ms(lambda: torch._foreach_norm(leaves), **kw)
    _entry(res, "flat_l2norm",
           time_ms(lambda: mta.flat_l2norm_partials_kernel(x), **kw),
           time_ms(lambda: mta.flat_l2norm_partials_plain(x), **kw),
           time_ms(lambda: torch.linalg.vector_norm(x), **kw),
           4 * nel + 4 * (nel // mta.SUB), 2 * nel, FP32_FLOPS,
           f"flat_l2norm_partials {label}",
           f"torch._foreach_norm over the tensors {t_fn:.5f}; "
           "torch.linalg.vector_norm of the buffer")
    res["flat_l2norm"]["foreach_norm_ms"] = t_fn
    del x, y, leaves
    torch.cuda.empty_cache()
    for m_dtype, key in ((torch.float32, "flat_lamb_stage1"),
                         (torch.bfloat16, "flat_lamb_stage1_bf16m")):
        g, p, m, v, hp, spec, _ = lamb_inputs(dev, m_dtype, gen)
        # reads g, p, v and m; writes v, u and m; and the two partials
        nbytes = nel * (4 * 3 + 4 * 2 + 2 * m.element_size()) \
            + 2 * 4 * (nel // mta.SUB)
        _entry(res, key,
               time_ms(lambda: mta.flat_lamb_stage1_kernel(g, p, m, v, hp),
                       **kw),
               time_ms(lambda: mta.flat_lamb_stage1_plain(g, p, m, v, hp),
                       **kw),
               None, nbytes, 24 * nel, FP32_FLOPS,
               f"flat_lamb_stage1 {label}, m {str(m_dtype)[6:]}", "none")
        del g, p, m, v
        torch.cuda.empty_cache()
    return res


def resnet_flat(dev):
    """ResNet-50's params packed as the flat FusedSGD packs them: (the
    fp32 buffer, its spec)."""
    from apex_tpu_torch.models.resnet import init_resnet
    from apex_tpu_torch.multi_tensor_apply.flatten import flatten_tensors
    from apex_tpu_torch.utils.tree import tree_flatten

    params, _ = init_resnet(torch.Generator(device=dev).manual_seed(0),
                            RESNET_DEPTH, RESNET_CLASSES, device=dev)
    return flatten_tensors(tree_flatten(params)[0])


def _library_or_reason(fn, kw):
    """Time a PyTorch library call, or give the reason it has none on
    this card (its error's first line)."""
    try:
        fn()
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError) as e:
        return None, str(e).splitlines()[0][:160]
    return time_ms(fn, **kw), None


def sgd_family_times(dev):
    """flat_sgd on ResNet-50's flat buffer (the main path's shape) and on
    BERT-Large's; flat_adagrad and flat_novograd's elementwise pass on
    BERT-Large's (their path). Library calls over the same tensors:
    ``torch._fused_sgd_`` (``torch.optim.SGD(fused=True)``'s kernel, in
    place, the momentum buffers seeded) and ``torch._fused_adagrad_``
    where the card's torch has a CUDA kernel for it; NovoGrad has
    none."""
    from apex_tpu_torch.multi_tensor_apply.flatten import unflatten_tensors

    mta = kernel_modules()[4]
    phase("times of flat_sgd, flat_adagrad and flat_novograd (device ms per "
          "call, CUDA-graph replays of 3 calls)")
    bf, f32 = torch.bfloat16, torch.float32
    gen = torch.Generator(device=dev).manual_seed(15)
    kw = dict(reps=5, inner=3)
    res = {}
    sgd_kw = dict(lr=0.1, momentum=0.9, dampening=0.0, weight_decay=1e-4,
                  nesterov=False, wd_after_momentum=False,
                  first_run=False, grad_scale=1.0, device=dev)
    hp = mta.sgd_hparams(**sgd_kw)
    for where, make in (("resnet50", resnet_flat), ("bert", bert_flat)):
        p, spec = make(dev)
        g = _rand(gen, p.shape, f32, dev, 1e-3)
        nel = p.numel()
        label = f"({spec.total_rows}, 128) fp32"
        for buf_dt, emit in ((f32, None), (bf, bf)):
            buf = _rand(gen, p.shape, f32, dev, 1e-3).to(buf_dt)
            key = f"flat_sgd_{where}" + ("_bf16buf_castout" if emit else "")
            lib, why = None, "none (bf16 buffer and cast-out)"
            if emit is None:
                views = [unflatten_tensors(t, spec) for t in (p, g, buf)]
                lib, why = _library_or_reason(lambda: torch._fused_sgd_(
                    views[0], views[1], views[2], weight_decay=1e-4,
                    momentum=0.9, lr=0.1, dampening=0.0, nesterov=False,
                    maximize=False, is_first_step=False), kw)
                why = why or "torch._fused_sgd_ over the tree's tensors"
            # reads g, p, buf; writes p, buf (and the cast-out)
            nbytes = nel * (4 + 4 * 2 + 2 * buf.element_size()
                            + (2 if emit else 0))
            _entry(res, key,
                   time_ms(lambda: mta.flat_sgd_kernel(g, p, buf, hp, None,
                                                       emit), **kw),
                   time_ms(lambda: mta.flat_sgd_plain(g, p, buf, hp, None,
                                                      emit), **kw),
                   lib, nbytes, 8 * nel, FP32_FLOPS,
                   f"flat_sgd {where} {label}, buf {str(buf_dt)[6:]}"
                   f"{', bf16 cast-out' if emit else ''}", why)
            del buf
        if where == "bert":
            s = _rand(gen, p.shape, f32, dev, 1e-3).abs()
            hpa = mta.adagrad_hparams(lr=1e-2, eps=1e-10, weight_decay=0.01,
                                      adagrad_w_mode=False, grad_scale=1.0,
                                      device=dev)
            views = [unflatten_tensors(t, spec) for t in (p, g, s)]
            steps = [torch.ones((), device=dev) for _ in views[0]]
            lib, why = _library_or_reason(lambda: torch._fused_adagrad_(
                views[0], views[1], views[2], steps, lr=1e-2, lr_decay=0.0,
                weight_decay=0.01, eps=1e-10, maximize=False), kw)
            _entry(res, "flat_adagrad",
                   time_ms(lambda: mta.flat_adagrad_kernel(g, p, s, hpa),
                           **kw),
                   time_ms(lambda: mta.flat_adagrad_plain(g, p, s, hpa),
                           **kw),
                   lib, nel * 20, 10 * nel, FP32_FLOPS,
                   f"flat_adagrad bert {label}",
                   "torch._fused_adagrad_ over the tree's tensors" if why is
                   None else f"none: torch._fused_adagrad_ on CUDA raises "
                   f"'{why}'")
            res["flat_adagrad"]["library_note"] = why
            del s, views
            m = _rand(gen, p.shape, f32, dev, 1e-3)
            den = _rand(gen, (nel // mta.SUB,), f32, dev, 1.0).abs() + 0.1
            hpn = mta.novograd_hparams(lr=1e-3, beta1=0.95, step=2,
                                       weight_decay=0.01,
                                       grad_averaging=True,
                                       bias_correction=True,
                                       reg_inside_moment=False,
                                       grad_scale=1.0, device=dev)
            _entry(res, "flat_novograd",
                   time_ms(lambda: mta.flat_novograd_kernel(g, p, m, den,
                                                            hpn), **kw),
                   time_ms(lambda: mta.flat_novograd_plain(g, p, m, den,
                                                           hpn), **kw),
                   None, nel * 20 + 4 * (nel // mta.SUB), 10 * nel,
                   FP32_FLOPS, f"flat_novograd bert {label}, elementwise "
                   "pass (the L2 partials pre-pass is row 15)", "none")
            del m, den
        del p, g
        torch.cuda.empty_cache()
    return res


def _cycle(fns):
    """One callable that calls ``fns`` in turn."""
    it = itertools.cycle(fns)
    return lambda: next(it)()


def w8_times(dev):
    """Rows 21-23 at M 8 (a decode step's slots), M 128 (the smallest
    prefill bucket; rows 21-22), M 1 (row 23: a prefill takes the logits
    of its last real token) and M 1024 (a 1024-token prefill), bf16 x
    as on the O2 path. The linears are timed over 24 weight copies, one
    call each in turn, as a step reads its 24 layers (72-96 MB, past the
    50 MB L2); the word table is read once (51.5 MB). The library call is
    ``torch._weight_int8pack_mm`` where the card's torch has it for CUDA
    (bf16 scales and output, no bias; the KN rows on transposed copies
    made outside the timing); else ``torch.matmul``/``addmm`` over the
    weights dequantized to bf16, a different function (it reads bf16
    weights). Rows 21-22 also time the bf16 serving path's own linear on
    the dequantized bf16 weights (``torch.addmm(bias, x, w_bf16)``, or
    ``torch.matmul`` without the bias): a different function, reading
    twice the weight bytes, and the yardstick a w8 prefill has to
    approach."""
    from apex_tpu_torch.quant import dequantize_tensor

    w8 = kernel_modules()[5]
    phase("times of the int8 weight-only matmuls at M 8, 128, 1 and 1024 "
          "(bf16 x; device ms per call, CUDA-graph replays)")
    gen = torch.Generator(device=dev).manual_seed(15)
    bf, f32 = torch.bfloat16, torch.float32
    int8pack = torch._C._dispatch_has_kernel_for_dispatch_key(
        "aten::_weight_int8pack_mm", "CUDA")
    lib_name = ("torch._weight_int8pack_mm (bf16 scales and out, no bias)"
                if int8pack else "torch.matmul over the weights dequantized "
                "to bf16 (a different function)")
    res = {"w8_library": lib_name}
    for name, (k, n), kind, copies in (
            ("w8_matmul", W8_LINEARS[0], "bias", 24),
            ("w8_matmul_nobias", W8_LINEARS[3], "nobias", 24),
            ("w8_matmul_nk", W8_TABLE, "nk", 1)):
        nk = kind == "nk"
        ops = [w8_operands(gen, dev, 1, k, n, bf, nk, kind == "bias")
               for _ in range(copies)]
        deq = [dequantize_tensor(o[1], o[2], -1 if nk else -2, bf)
               for o in ops]
        for m in (8, 1, 1024) if nk else (8, 128, 1024):
            x = _rand(gen, (m, k), bf, dev)
            if nk:
                fk = [lambda o=o: w8.w8_matmul_nk_kernel(x, o[1], o[2], f32)
                      for o in ops]
                fp = [lambda o=o: w8.w8_matmul_nk_plain(x, o[1], o[2], f32)
                      for o in ops]
            else:
                fk = [lambda o=o: w8.w8_matmul_kernel(x, o[1], o[2], o[3], bf)
                      for o in ops]
                fp = [lambda o=o: w8.w8_matmul_plain(x, o[1], o[2], o[3], bf)
                      for o in ops]
            if nk:
                lin = [lambda d=d: torch.matmul(x, d.t()) for d in deq]
            elif kind == "bias":
                lin = [lambda d=d, o=o: torch.addmm(o[3], x, d)
                       for d, o in zip(deq, ops)]
            else:
                lin = [lambda d=d: torch.matmul(x, d) for d in deq]
            if int8pack:
                packed = [(o[1] if nk else o[1].t().contiguous(),
                           o[2].to(bf)) for o in ops]
                fl = [lambda p=p: torch._weight_int8pack_mm(x, *p)
                      for p in packed]
            else:
                fl = lin
            kw = dict(inner=copies) if copies > 1 else dict(inner=5)
            nbytes = (m * k * 2 + k * n + n * 4 + (n * 2 if kind == "bias"
                                                   else 0)
                      + m * n * (4 if nk else 2))
            key = f"{name}_m{m}"
            _entry(res, key, time_ms(_cycle(fk), **kw),
                   time_ms(_cycle(fp), **kw), time_ms(_cycle(fl), **kw),
                   nbytes, 2 * m * k * n, BF16_TC_FLOPS,
                   f"{name} M {m} K {k} N {n} bf16 x", lib_name)
            if not nk:
                t = time_ms(_cycle(lin), **kw)
                res[key]["bf16_linear_ms"] = t
                print(f"  the bf16 serving linear on the dequantized bf16 "
                      f"weights ({'addmm' if kind == 'bias' else 'matmul'}; "
                      f"a different function): {t:.5f}", flush=True)
            del x, fk, fp, fl, lin
        del ops, deq
        torch.cuda.empty_cache()
    return res


# The integer-ALU operations an element (csrc/threefry.cu's note): the 20
# rounds' funnel shift and xor (40), the xor of the two words (1) and, for
# the dropout, the shift and or that build the uniform (2). Funnel shifts
# and logic ops run only on the integer ALU, 64 lanes an SM on Hopper;
# the 32 adds of the hash can run as IMAD on the FMA pipe beside them,
# so the ALU operations bound the kernels.
BITS_ALU_OPS, DROPOUT_ALU_OPS = 41, 43
ALU_LANES_PER_SM = 64


def max_sm_clock_mhz():
    """The card's maximum SM clock (``nvidia-smi``), or the H100 SXM's
    1980 MHz when it cannot be read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=60).stdout.split()
        return float(out[0]) if out else 1980.0
    except (OSError, subprocess.TimeoutExpired, ValueError):
        return 1980.0


def threefry_times(dev):
    """The bits kernel at the decode tick's (8, 50304) and at one key
    over BERT-Large's hidden shape; the dropout at the hidden shape and
    at the unfused attention's probabilities (bf16). Bounds: the
    integer-ALU operations over 64 lanes an SM at the maximum SM clock,
    or the bytes, the larger; ``F.dropout`` (Philox: a different
    function) beside."""
    p = kernel_modules()[6]
    clock = max_sm_clock_mhz()
    peak = (torch.cuda.get_device_properties(dev).multi_processor_count
            * ALU_LANES_PER_SM * clock * 1e6)
    phase(f"times of the threefry kernels (device ms per call; bound by "
          f"the integer ALU at {clock:.0f} MHz, {peak / 1e12:.2f} T op/s)")
    res = {}
    keys8 = p._to_int32(p.split(p.PRNGKey(1), 8)).to(dev)
    key1 = p._to_int32(p.PRNGKey(2)[None]).to(dev)
    for label, keys, n in (("threefry_bits_8x50304", keys8, 50304),
                           ("threefry_bits_hidden", key1,
                            64 * 128 * 1024)):
        elems = keys.shape[0] * n
        _entry(res, label,
               time_ms(lambda: p.threefry_bits_kernel(keys, n, dev)),
               time_ms(lambda: p.threefry_bits_plain(keys, n, dev)), None,
               4 * elems, BITS_ALU_OPS * elems, peak,
               f"threefry bits, {keys.shape[0]} key(s) x {n}", "no library")
    # the card's launch floor: one 1-element op in the same harness (a
    # floor on any launch's time, not a bound on the bits' work)
    one = torch.zeros(1, device=dev)
    floor = time_ms(lambda: one.add_(1))
    res["threefry_bits_8x50304"]["launch_floor_ms"] = floor
    print(f"  launch floor (a 1-element add_, CUDA-graph replays): "
          f"{floor:.5f}", flush=True)
    gen = torch.Generator(device=dev).manual_seed(12)
    words = p.host_bits(p.PRNGKey(3), 2)
    for label, shape in (("threefry_dropout_hidden", HIDDEN_SHAPE),
                         ("threefry_dropout_probs", PROBS_SHAPE)):
        x = _rand(gen, shape, torch.bfloat16, dev)
        _entry(res, label,
               time_ms(lambda: p.dropout_kernel(x, words, 0.1)),
               time_ms(lambda: p.dropout_plain(x, words, 0.1)), None,
               2 * 2 * x.numel(), DROPOUT_ALU_OPS * x.numel(), peak,
               f"threefry dropout {shape} bf16 rate 0.1", "no library")
        t_f = time_ms(lambda: F.dropout(x, 0.1, training=True))
        res[label]["f_dropout_ms"] = t_f
        print(f"  F.dropout at the same shape (Philox bits: a different "
              f"function): {t_f:.5f}", flush=True)
    for v in res.values():
        v["bound_clock_mhz"] = clock
    del x
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# 8. GPT: RoPE serving and training (the JAX package's decode benchmark's
#    RoPE model, bench.py's _decode_bench_setup, and its tp=1 GPT-medium
#    step, gpt_tp_bench(on_tpu, n_devices=1))
# ---------------------------------------------------------------------------

GPT_BATCH, GPT_SEQ, GPT_STEPS = 8, 1024, 6
GPT_SMALL_BATCH, GPT_SMALL_SEQ, GPT_SMALL_LAYERS = 2, 256, 2
U32_ULP = 2.0 ** -24


def _gpt_qkv(gen, dev, b, h, s, d):
    """q, k, v as the GPT training path hands them to flash: q and k
    rotated by RoPE from the ``_split_qkv`` views of a fused (b, s, 3 h
    d) bf16 projection, v still a view."""
    from apex_tpu_torch.models.gpt import _split_qkv
    from apex_tpu_torch.transformer.functional import (
        fused_apply_rotary_pos_emb_bhsd, rope_frequencies,
    )

    q, k, v = _split_qkv(_rand(gen, (b, s, 3 * h * d), torch.bfloat16,
                               dev), d)
    freqs = rope_frequencies(d, s, device=dev)
    return (fused_apply_rotary_pos_emb_bhsd(q, freqs),
            fused_apply_rotary_pos_emb_bhsd(k, freqs), v)


def gpt_kernel_parity(dev):
    """The flash forward, dq and dk/dv at GPT-medium's training shape
    (causal, b 8, h 16, s 1024, d 64, bf16; q and k out of RoPE, v a
    view of the projection; with and without a key mask as prefill
    passes one), and the cross entropy on (8192, 50304) bf16 logits,
    each against its plain version per element to its error model."""
    fa, xent = kernel_modules()[1:3]
    phase("kernel parity at GPT-medium's training shapes (flash causal b8 "
          "h16 s1024 d64 bf16, RoPE'd q and k, v a view: o_limit and "
          "bwd_limits; cross entropy (8192, 50304) bf16: xentropy.limits; "
          "a second launch gives the same bits)")
    gen = torch.Generator(device=dev).manual_seed(21)
    b, h, s, d = GPT_BATCH, 16, GPT_SEQ, 64
    worst = {"fwd": 0.0, "dq": 0.0, "dkv": 0.0, "xent_fwd": 0.0,
             "xent_bwd": 0.0}
    seed, kw = (0, 0), dict(causal=True, scale=d ** -0.5, rate=0.0)
    q, k, v = _gpt_qkv(gen, dev, b, h, s, d)
    do = _rand(gen, (b, s, h, d), torch.bfloat16, dev).transpose(1, 2)
    for mask in (None, _flash_mask(b, s, dev, 8)):
        o, lse = fa.attention_fwd_kernel(q, k, v, mask, seed, **kw)
        o2, lse2 = fa.attention_fwd_kernel(q, k, v, mask, seed, **kw)
        got = fa.attention_bwd_kernel(q, k, v, mask, o, lse, do, seed, **kw)
        again = fa.attention_bwd_kernel(q, k, v, mask, o, lse, do, seed,
                                         **kw)
        torch.cuda.synchronize()
        o0, lse0 = fa.attention_fwd_plain(q, k, v, mask, seed, **kw)
        e_o, use_o = _held(o, o0, fa.o_limit(q, k, v, mask, o0, causal=True,
                                             scale=d ** -0.5))
        fin = torch.isfinite(lse0)
        le = float((lse - lse0)[fin].abs().max())
        ok = use_o <= 1.0 and le <= LSE_TOL[torch.bfloat16]
        ok &= torch.equal(o, o2) and torch.equal(lse, lse2)
        want = fa.attention_bwd_plain(q, k, v, mask, o, lse, do, seed, **kw)
        lims = fa.bwd_limits(q, k, v, mask, o, lse, do, *want, **kw)
        parts = []
        for name, g, g2, w0, lim in zip(("dq", "dk", "dv"), got, again,
                                        want, lims):
            e, use = _held(g, w0, lim)
            ok &= use <= 1.0 and bool(torch.isfinite(g).all())
            ok &= torch.equal(g, g2)
            key = "dq" if name == "dq" else "dkv"
            worst[key] = max(worst[key], e)
            parts.append(f"{name} {e:.3g} ({use:.2f})")
        worst["fwd"] = max(worst["fwd"], e_o)
        check(ok, f"flash causal b{b} h{h} s{s} d{d} bf16, RoPE'd q and k "
              f"({_load_variant(q, k)}), v a view ({_load_variant(v)}), "
              f"mask={mask is not None}: max_abs_err (share of its "
              f"tolerance) o {e_o:.3g} ({use_o:.2f}), lse {le:.3g}, "
              + ", ".join(parts) + "; repeats bit-equal")
        del o, o2, got, again, want, lims, o0
    del q, k, v, do
    torch.cuda.empty_cache()
    n, vv = GPT_BATCH * GPT_SEQ, 50304
    x = _rand(gen, (n, vv), torch.bfloat16, dev, 3.0)
    labels = torch.randint(0, vv, (n,), generator=gen, device=dev)
    dloss = torch.full((n,), 1.0 / n, device=dev)   # the mean's gradient
    loss, lse = xent.xentropy_fwd_kernel(x, labels, 0.0)
    dx = xent.xentropy_bwd_kernel(x, labels, lse, dloss, 0.0)
    dx2 = xent.xentropy_bwd_kernel(x, labels, lse, dloss, 0.0)
    loss2, _ = xent.xentropy_fwd_kernel(x, labels, 0.0)
    torch.cuda.synchronize()
    loss0, lse0 = xent.xentropy_fwd_plain(x, labels, 0.0)
    dx0 = xent.xentropy_bwd_plain(x, labels, lse0, dloss, 0.0)
    lims = xent.limits(x, labels, 0.0, loss0, lse0, dloss, dx0)
    res = [_held(g, w0, lim) for g, w0, lim in zip(
        (loss, lse, dx), (loss0, lse0, dx0), lims)]
    ok = all(use <= 1.0 for _, use in res) and dx.dtype == torch.bfloat16
    ok &= torch.equal(dx, dx2) and torch.equal(loss, loss2)
    worst["xent_fwd"] = max(res[0][0], res[1][0])
    worst["xent_bwd"] = res[2][0]
    check(ok, f"xentropy ({n}, {vv}) bf16 (393 x 128 columns): max_abs_err "
          "(share of its tolerance) " + ", ".join(
              f"{nm} {e:.3g} ({use:.2f})" for nm, (e, use) in zip(
                  ("loss", "lse", "dx bf16"), res)) + "; repeats bit-equal")
    return worst


def _rope_limit(t, cos, sin, want):
    """The RoPE error model (``fused_rope``'s docstring): 8 u of |t| |cos|
    + |rotate_half(t)| |sin| on the rotated channels, plus one ulp of a
    bf16 output."""
    from apex_tpu_torch.transformer.functional.fused_rope import (
        _rotate_half,
    )

    t = t.float()
    lim = 8 * U32_ULP * (t.abs() * cos.abs()
                         + _rotate_half(t).abs() * sin.abs())
    if want.dtype == torch.bfloat16:
        lim = lim + 2.0 ** -7 * want.float().abs()
    return lim


def rope_parity(dev):
    """RoPE on the card against the same calls on the CPU: the forward
    and dt at the training shape (q of the fused projection, bf16) and
    at the decode tick with per-slot positions; dcos and dsin of the
    cached form; each call's device time."""
    from apex_tpu_torch.models.gpt import _split_qkv
    from apex_tpu_torch.transformer.functional import fused_rope as rope
    from apex_tpu_torch.transformer.functional.fused_rope import (
        _rotate_half,
    )

    phase("RoPE, card vs CPU (fused_rope's error model: 8 u (|t| |cos| + "
          "|rotate_half(t)| |sin|) plus one ulp of a bf16 output; dcos, "
          "dsin 2 n u sum |g t| over the n broadcast terms)")
    gen = torch.Generator(device=dev).manual_seed(22)
    b, h, d = GPT_BATCH, 16, 64
    out = {}
    cases = (("train", GPT_SEQ, None), ("decode", 1, "per-slot"))
    for name, s, positions in cases:
        t = _split_qkv(_rand(gen, (b, s, 3 * h * d), torch.bfloat16, dev),
                       d)[0].requires_grad_(True)
        g = _rand(gen, (b, h, s, d), torch.bfloat16, dev)
        # training rotates rows 0..s-1 of an s-row table; decode gathers
        # each slot's row of the cache's S_max-row table
        freqs = rope.rope_frequencies(d, s if positions is None else
                                      MAX_LEN, device=dev)
        pos = None if positions is None else torch.linspace(
            0, MAX_LEN - 1, b, device=dev).long()
        y = rope.fused_apply_rotary_pos_emb_bhsd(t, freqs, pos)
        (dt,) = torch.autograd.grad(y, (t,), g)
        tc = t.detach().cpu().requires_grad_(True)
        yc = rope.fused_apply_rotary_pos_emb_bhsd(
            tc, freqs.cpu(), None if pos is None else pos.cpu())
        (dtc,) = torch.autograd.grad(yc, (tc,), g.cpu())
        f2 = freqs.cpu().reshape(freqs.shape[0], d).double()
        idx = torch.arange(s) if pos is None else pos.cpu()[:, None]
        c = torch.cos(f2)[idx].reshape((1 if pos is None else b), 1, s, d)
        sn = torch.sin(f2)[idx].reshape(c.shape)
        yc = yc.detach()
        uy = _share(y.detach().cpu(), yc, _rope_limit(tc.detach(), c, sn,
                                                      yc))
        ud = _share(dt.cpu(), dtc, _rope_limit(g.cpu(), c, sn, dtc))
        check(uy <= 1.0 and ud <= 1.0 and y.dtype == torch.bfloat16,
              f"RoPE {name} ({b}, {h}, {s}, {d}) bf16"
              f"{', positions per slot' if pos is not None else ''}: "
              f"forward {uy:.3f} and dt {ud:.3f} of their limits")
        tv = t.detach()
        t_f = time_ms(lambda: rope.fused_apply_rotary_pos_emb_bhsd(
            tv, freqs, pos))
        # the backward's dt: the same form with -sin, on the tables the
        # forward gathered (autograd stays out of the captured graph)
        cd, sd = c.float().to(dev), sn.float().to(dev)
        t_fb = t_f + time_ms(lambda: rope._apply(g, cd, -sd))
        # one read of t and one write of the output, the table's rows
        nbytes = 2 * t.numel() * 2 + 2 * s * d * 4
        out[name] = dict(fwd_ms=t_f, fwd_bwd_ms=t_fb, bound_ms=bound(
            nbytes, 6 * t.numel(), FP32_FLOPS)[0], forward_share=uy,
            dt_share=ud)
        print(f"RoPE {name}: forward {t_f:.5f} ms, forward + dt "
              f"{t_fb:.5f} ms a call (CUDA-graph replays), bytes bound "
              f"{out[name]['bound_ms']:.5f}", flush=True)
    cos, sin = rope.rope_cos_sin(d, GPT_SEQ, device=dev)
    t = _rand(gen, (GPT_SEQ, b, h, d), torch.float32, dev)
    g = _rand(gen, (GPT_SEQ, b, h, d), torch.float32, dev)
    got, want = [], []
    for dv, lst in ((dev, got), ("cpu", want)):
        cc = cos.to(dv).requires_grad_(True)
        ss = sin.to(dv).requires_grad_(True)
        y = rope.fused_apply_rotary_pos_emb_cached(t.to(dv), cc, ss)
        lst += torch.autograd.grad(y, (cc, ss), g.to(dv))
    tt, gg = t.cpu().double(), g.cpu().double()
    lims = [2 * b * h * U32_ULP * (gg * x).abs().sum((1, 2), keepdim=True)
            for x in (tt, _rotate_half(tt))]
    uc = max(_share(a.cpu(), w, lim) for a, w, lim in zip(got, want, lims))
    check(uc <= 1.0, f"RoPE cached ({GPT_SEQ}, {b}, {h}, {d}) fp32: dcos "
          f"and dsin {uc:.3f} of their limits")
    out["cached_table_grads_share"] = uc
    return out


def gpt_per_step_launches(L, remat, dropout, flat):
    """Exact launches of each kernel in one GPT step of ``L`` layers
    (``examples/gpt/train.py``): forward 2L + 1 LayerNorms, L flash
    forwards, one cross entropy; backward the same LayerNorms, L dq and L
    dk/dv, one cross-entropy backward. With ``remat`` each layer's
    forward runs again in the backward up to its last saved result, the
    fc2 product (non-reentrant checkpoint's early stop): 2 more
    LayerNorms, one more flash forward and, with dropout, the attention
    output's dropout (salt 0) again, but not fc2's (salt 1). Dropout
    launches once forward and once backward (the backward regenerates
    the mask) after each layer's attention output and fc2: 2L + 2L,
    plus L under remat. The flat FusedAdam launches ``flat_adam`` once;
    the tree path no kernel."""
    rec = L if remat else 0
    out = dict.fromkeys(KERNEL_NAMES, 0)
    out.update(layer_norm_fwd=2 * L + 1 + 2 * rec, layer_norm_bwd=2 * L + 1,
               flash_attention_fwd=L + rec, flash_attention_bwd_dq=L,
               flash_attention_bwd_dkv=L, xentropy_fwd=1, xentropy_bwd=1)
    if dropout:
        out["threefry_dropout"] = 4 * L + rec
    if flat:
        out["flat_adam"] = 1
    return out


# The GPT card-vs-CPU step: gradients, m, v and master to STEP_LIMITS (the
# BERT check's). The loss with bf16 compute differs: GPT's tied logits are
# bf16 (BERT's MLM logits are cast to fp32 before the loss), and card and
# CPU sum each logit's products in other orders before that rounding, so a
# logit may land one bf16 ulp apart and the loss carries it: held to the
# bf16 loss limit the CPU parity tests give the port against JAX (2e-4
# relative, tests/test_torch_gpt_train.py and test_torch_bert_train.py;
# 2.98e-05 measured on an H100 at these seeds).
GPT_STEP_LIMITS = {"O0": STEP_LIMITS["O0"],
                   "O2": dict(STEP_LIMITS["O2"], loss=2e-4)}
GPT_SMALL_CASES = {  # name -> (compute dtype, use_rope, dropout)
    "fp32": (None, False, False), "fp32 rope": (None, True, False),
    "bf16": (torch.bfloat16, False, False),
    "bf16 rope": (torch.bfloat16, True, False),
    "bf16 rope dropout": (torch.bfloat16, True, True),
}


def gpt_train_small(dev):
    """One step of GPT-medium width (h 1024, 16 heads, vocab 50304) at 2
    layers on the card and on the CPU from the same weights and batch:
    fp32 and bf16 compute, each with learned positions and with RoPE,
    and bf16 with RoPE and dropout 0.1; held to the BERT check's limits
    (``STEP_LIMITS``: fp32 compute as O0, bf16 as O2), the bf16 loss to
    ``GPT_STEP_LIMITS``."""
    import dataclasses

    from apex_tpu_torch.examples.gpt.train import (
        make_gpt_train_step, make_state, synthetic_batch,
    )
    from apex_tpu_torch.models.gpt import gpt_medium
    from apex_tpu_torch.utils.tree import tree_map

    p = kernel_modules()[6]
    out = {}
    b, s, L = GPT_SMALL_BATCH, GPT_SMALL_SEQ, GPT_SMALL_LAYERS
    for name, (cdt, rope, drop) in GPT_SMALL_CASES.items():
        lim = GPT_STEP_LIMITS["O0" if cdt is None else "O2"]
        cfg = dataclasses.replace(gpt_medium(), num_layers=L, use_rope=rope)
        key = p.PRNGKey(DROPOUT_SEED) if drop else None
        phase(f"GPT training ({name}), card vs CPU: GPT-medium width, {L} "
              f"layers (remat), batch {b}, seq {s}, one step of "
              "make_gpt_train_step (FusedAdam lr 1e-4, wd 0.01)"
              + (f", dropout {cfg.hidden_dropout}" if drop else ""))
        step_d = make_gpt_train_step(cfg, compute_dtype=cdt, dropout_rng=key)
        step_c = make_gpt_train_step(cfg, compute_dtype=cdt, dropout_rng=key)
        params_d, opt_d = make_state(cfg, step_d.opt, 0, dev)
        params_c = tree_map(lambda t: t.cpu(), params_d)
        opt_c = step_c.opt.init(params_c)
        ids = synthetic_batch(0, b, s, cfg.vocab_size, dev)
        ids_c = synthetic_batch(0, b, s, cfg.vocab_size, "cpu")
        check(torch.equal(ids.cpu(), ids_c), "same ids on both devices")
        k0 = None if key is None else p.fold_in(key, 0)
        t0 = time.perf_counter()
        _, grads_d = step_d.grads(params_d, ids, ids, dropout_rng=k0)
        new_d = step_d(params_d, opt_d, ids, ids)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        _, grads_c = step_c.grads(params_c, ids_c, ids_c, dropout_rng=k0)
        new_c = step_c(params_c, opt_c, ids_c, ids_c)
        t2 = time.perf_counter()
        loss_d, loss_c = float(new_d[2]), float(new_c[2])
        got = {"loss": abs(loss_d - loss_c) / abs(loss_c),
               "grads": _relnorm(grads_d, grads_c),
               "m": _relnorm(new_d[1].m, new_c[1].m),
               "v": _relnorm(new_d[1].v, new_c[1].v),
               "master": _maxabs(new_d[0], new_c[0])}
        print(f"card {t1 - t0:.2f} s, CPU {t2 - t1:.2f} s; loss card "
              f"{loss_d:.6f}, CPU {loss_c:.6f}", flush=True)
        for k, val in got.items():
            what = "max abs" if k == "master" else "relative"
            check(val <= lim[k] and np.isfinite(val), f"{name} {k}: card "
                  f"vs CPU {what} {val:.3g} <= {lim[k]:g}")
        out[name] = got
        del params_d, opt_d, grads_d, new_d, step_d
        torch.cuda.empty_cache()
    return out


GPT_BIG = {  # name -> (use_rope, dropout, flat FusedAdam)
    "gpt_tree": (False, False, False),
    "gpt_rope_dropout": (True, True, True),
}


def gpt_train_big(dev, kern):
    """Six steps of full GPT-medium (24 layers, remat) at gpt_tp_bench's
    tp=1 shape, batch 8, seq 1024, bf16 compute over fp32 params, on one
    fixed batch from ``randint(PRNGKey(1000))`` with labels = ids:
    ``gpt_tree`` (the JAX benchmark's step exactly, tree FusedAdam) and
    ``gpt_rope_dropout`` (RoPE, dropout 0.1 on ``fold_in(PRNGKey(0),
    step)``, flat FusedAdam). Counts set to 0 before each run and read
    after it; losses finite and falling; exact launches a step."""
    import dataclasses

    from apex_tpu_torch.examples.gpt.train import (
        make_gpt_train_step, make_state, synthetic_batch,
    )
    from apex_tpu_torch.models.gpt import gpt_medium
    from apex_tpu_torch.optimizers import FusedAdam
    from apex_tpu_torch.utils.tree import tree_leaves

    p = kernel_modules()[6]
    out = {}
    for name, (rope, drop, flat) in GPT_BIG.items():
        cfg = dataclasses.replace(gpt_medium(), use_rope=rope)
        L = cfg.num_layers
        per_step = gpt_per_step_launches(L, cfg.remat, drop, flat)
        phase(f"GPT training ({name}): gpt_medium ({L} layers, remat "
              f"{cfg.remat}, {'RoPE' if rope else 'learned positions'}), "
              f"batch {GPT_BATCH}, seq {GPT_SEQ}, bf16 compute over fp32 "
              f"params, {'flat' if flat else 'tree'} FusedAdam(lr=1e-4, "
              f"weight_decay=0.01), {GPT_STEPS} steps"
              + (f", dropout {cfg.hidden_dropout} on fold_in(PRNGKey("
                 f"{DROPOUT_SEED}), step)" if drop else ""))
        step = make_gpt_train_step(
            cfg, FusedAdam(lr=1e-4, weight_decay=0.01, use_flat_kernel=flat),
            dropout_rng=p.PRNGKey(DROPOUT_SEED) if drop else None)
        params, opt_state = make_state(cfg, step.opt, 0, dev)
        ids = synthetic_batch(0, GPT_BATCH, GPT_SEQ, cfg.vocab_size, dev)
        n_params = sum(t.numel() for t in tree_leaves(params))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for k in kern.values():
            k.launches = 0
        losses, times, steps_ok = [], [], True
        for _ in range(GPT_STEPS):
            before = {n: k.launches for n, k in kern.items()}
            t0 = time.perf_counter()
            params, opt_state, loss = step(params, opt_state, ids, ids)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            losses.append(loss)
            steps_ok &= all(kern[n].launches - before[n] == per_step[n]
                            for n in kern)
        launches = {n: k.launches for n, k in kern.items()}
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        losses = [float(x) for x in losses]
        print(f"losses {[round(x, 5) for x in losses]}", flush=True)
        check(all(np.isfinite(losses)) and losses[-1] < losses[0],
              "every loss finite, the last below the first")
        check(steps_ok and all(launches[n] == GPT_STEPS * per_step[n]
                               for n in kern),
              f"launches per step exactly "
              f"{ {n: c for n, c in per_step.items() if c} } (every other "
              f"kernel 0; {launches} over {GPT_STEPS} steps)")
        med = statistics.median(times[1:])
        print(f"smoke reading, not a benchmark: median step "
              f"{med * 1e3:.1f} ms over steps 2-{GPT_STEPS} "
              f"({GPT_BATCH * GPT_SEQ / med:.0f} tokens/s); first step "
              f"{times[0] * 1e3:.1f} ms; peak device memory {peak:.2f} GiB; "
              f"{n_params} parameters", flush=True)
        out[name] = dict(losses=losses, step_ms=[t * 1e3 for t in times],
                         median_step_ms=med * 1e3,
                         tokens_per_s=GPT_BATCH * GPT_SEQ / med,
                         launches=launches, per_step=per_step,
                         peak_gib=peak, parameters=n_params)
        del params, opt_state, step
        torch.cuda.empty_cache()
    return out


def pretrain_defaults(dev):
    """``examples/gpt/pretrain_gpt.py`` at its defaults (the reference
    CLI's: 4 layers, h 64, seq 64, global batch 8 in 4 microbatches, 10
    steps) on the card: finite losses on its printed steps, then DONE."""
    import contextlib
    import io

    from apex_tpu_torch.examples.gpt import pretrain_gpt

    phase("pretrain_gpt.py at its defaults on the card")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = pretrain_gpt.main([])
    text = buf.getvalue()
    print(text, end="", flush=True)
    losses = [float(ln.split()[3]) for ln in text.splitlines()
              if ln.startswith("step ")]
    check(rc == 0 and len(losses) >= 3 and all(np.isfinite(losses))
          and text.strip().endswith("DONE"),
          f"{len(losses)} finite losses printed, then DONE")
    return losses


def serve_rope(dev, kern):
    """``serving_rope``: GPT-medium with ``use_rope=True`` (the JAX decode
    benchmark's model: bench.py's _decode_bench_setup), random weights
    from seed 0, no position table; decode logits against the full
    forward (fp32 and O2), then the 16 requests on the O2 params twice:
    the replay commits the same streams, exact launches."""
    import dataclasses

    from apex_tpu_torch import amp
    from apex_tpu_torch.models.gpt import gpt_medium, init_gpt

    phase("serving_rope: gpt_medium with use_rope=True (no position "
          "table), 16 greedy requests x 32 tokens, 8 slots, run twice")
    cfg = dataclasses.replace(gpt_medium(), use_rope=True)
    L = cfg.num_layers
    params = init_gpt(cfg, torch.Generator().manual_seed(0), device=dev)
    check("position" not in params["embedding"], "no position table")
    out = {}
    with torch.inference_mode():
        out["decode_err_fp32"] = decode_vs_full(
            params, cfg, dev, torch.float32, "RoPE, fp32 params and cache",
            1e-5)
        params = amp.initialize("O2", verbosity=0).cast_model(params)
        torch.cuda.empty_cache()
        out["decode_err_bf16"] = decode_vs_full(
            params, cfg, dev, torch.bfloat16,
            "RoPE, O2 bf16 params and cache", 0.0625)
        runs = [serve_mix(dev, cfg, params, kern) for _ in range(2)]
    check(runs[0]["streams"] == runs[1]["streams"],
          f"replay: the second run commits the same {N_REQUESTS} streams")
    sr = runs[0]
    forwards = N_REQUESTS + sr["decode_steps"]
    check_launches(sr["launches"], {
        "layer_norm_fwd": (2 * L + 1) * forwards,
        "flash_attention_fwd": L * N_REQUESTS}, "RoPE serving")
    print(f"smoke reading, not a benchmark: {sr['tokens_per_s']:.1f} and "
          f"{runs[1]['tokens_per_s']:.1f} tokens/s", flush=True)
    del sr["streams"]
    out.update(sr, replay_tokens_per_s=runs[1]["tokens_per_s"])
    return out


def gpt_times(dev):
    """The GPT-medium step's kernels at its shapes (device ms per call,
    CUDA-graph replays): the causal flash forward, dq and dk/dv at b 8,
    h 16, s 1024, d 64 on RoPE'd q and k and a view v, against SDPA's
    causal forward and backward; the cross entropy on (8192, 50304) bf16
    against ``F.cross_entropy``; ``flat_adam`` on GPT-medium's flat
    buffer against ``torch._fused_adamw_``. The LayerNorm's (8192,
    1024) bf16 x, fp32 w is the BERT step's shape, timed above."""
    from apex_tpu_torch.multi_tensor_apply.flatten import (
        flatten_tensors, unflatten_tensors,
    )
    from apex_tpu_torch.multi_tensor_apply.kernels import adam_hparams
    from apex_tpu_torch.models.gpt import gpt_medium, init_gpt
    from apex_tpu_torch.utils.tree import tree_flatten

    fa, xent = kernel_modules()[1:3]
    mta = kernel_modules()[4]
    phase("times at the GPT-medium step's shapes (batch 8, seq 1024; "
          "device ms per call, CUDA-graph replays)")
    gen = torch.Generator(device=dev).manual_seed(23)
    res = {}
    b, h, s, d = GPT_BATCH, 16, GPT_SEQ, 64
    q, k, v = _gpt_qkv(gen, dev, b, h, s, d)
    do = _rand(gen, (b, s, h, d), torch.bfloat16, dev).transpose(1, 2)
    kw = dict(causal=True, scale=d ** -0.5, rate=0.0)
    o, lse = fa.attention_fwd_kernel(q, k, v, None, (0, 0), **kw)
    delta = (do.float() * o.float()).sum(-1).reshape(-1, s)
    qc, kc, vc = (t.contiguous().requires_grad_(True) for t in (q, k, v))
    doc = do.contiguous()

    def sdpa():
        return F.scaled_dot_product_attention(qc, kc, vc, is_causal=True,
                                              scale=d ** -0.5)

    t_lf = time_ms(lambda: sdpa().detach())
    t_lfb = time_ms(lambda: torch.autograd.grad(sdpa(), (qc, kc, vc), doc))
    t_pb = time_ms(lambda: fa.attention_bwd_plain(q, k, v, None, o, lse, do,
                                                  (0, 0), **kw), reps=5,
                   inner=3)
    pairs = b * h * s * (s + 1) // 2
    qkvo = 4 * b * h * s * d * 2
    rowstats = 2 * b * h * s * 4
    label = f"b{b} h{h} s{s} d{d} causal bf16, RoPE'd q, k and a view v"
    _entry(res, "gpt_flash_fwd",
           time_ms(lambda: fa.attention_fwd_kernel(q, k, v, None, (0, 0),
                                                   **kw)),
           time_ms(lambda: fa.attention_fwd_plain(q, k, v, None, (0, 0),
                                                  **kw), reps=5, inner=3),
           t_lf, qkvo + b * h * s * 4, 4 * d * pairs, BF16_TC_FLOPS,
           f"flash fwd {label}", "scaled_dot_product_attention causal")
    _entry(res, "gpt_flash_dq",
           time_ms(lambda: fa.attention_dq_kernel(q, k, v, None, do, lse,
                                                  delta, (0, 0), **kw)),
           t_pb, t_lfb - t_lf, qkvo + rowstats + b * h * s * d * 2,
           6 * d * pairs, BF16_TC_FLOPS, f"flash dq {label}",
           "sdpa causal backward (fwd+bwd - fwd; plain: whole backward)")
    _entry(res, "gpt_flash_dkv",
           time_ms(lambda: fa.attention_dkv_kernel(q, k, v, None, do, lse,
                                                   delta, (0, 0), **kw)),
           t_pb, t_lfb - t_lf, qkvo + rowstats + 2 * b * h * s * d * 2,
           8 * d * pairs, BF16_TC_FLOPS, f"flash dk/dv {label}",
           "sdpa causal backward (fwd+bwd - fwd; plain: whole backward)")
    del q, k, v, do, o, qc, kc, vc, doc
    torch.cuda.empty_cache()
    n, vv = b * s, 50304
    logits = _rand(gen, (n, vv), torch.bfloat16, dev, 3.0)
    labels = torch.randint(0, vv, (n,), generator=gen, device=dev)
    dloss = torch.full((n,), 1.0 / n, device=dev)
    _, xlse = xent.xentropy_fwd_plain(logits, labels, 0.0)
    lr = logits.clone().requires_grad_(True)

    def ce():
        return F.cross_entropy(lr, labels, reduction="none")

    t_cf = time_ms(lambda: ce().detach(), inner=5)
    t_cfb = time_ms(lambda: torch.autograd.grad(ce(), lr, dloss.to(
        torch.bfloat16)), inner=5)
    _entry(res, "gpt_xent_fwd",
           time_ms(lambda: xent.xentropy_fwd_kernel(logits, labels, 0.0),
                   inner=5),
           time_ms(lambda: xent.xentropy_fwd_plain(logits, labels, 0.0),
                   reps=5, inner=3),
           t_cf, n * vv * 2 + n * 8 + 2 * n * 4, 4 * n * vv, FP32_FLOPS,
           f"xentropy fwd ({n}, {vv}) bf16", "F.cross_entropy (bf16)")
    _entry(res, "gpt_xent_bwd",
           time_ms(lambda: xent.xentropy_bwd_kernel(logits, labels, xlse,
                                                    dloss, 0.0), inner=5),
           time_ms(lambda: xent.xentropy_bwd_plain(logits, labels, xlse,
                                                   dloss, 0.0), reps=5,
                   inner=3),
           t_cfb - t_cf, 2 * n * vv * 2 + n * (8 + 4 + 4), 4 * n * vv,
           FP32_FLOPS, f"xentropy bwd ({n}, {vv}) bf16",
           "F.cross_entropy backward (bf16; fwd+bwd - fwd)")
    del logits, lr, xlse
    torch.cuda.empty_cache()
    params = init_gpt(gpt_medium(), torch.Generator(device=dev).manual_seed(
        0), device=dev)
    leaves, _ = tree_flatten(params)
    p, spec = flatten_tensors(leaves)
    del params, leaves
    g = _rand(gen, p.shape, torch.float32, dev, 1e-3)
    m = _rand(gen, p.shape, torch.float32, dev, 1e-4)
    vv2 = _rand(gen, p.shape, torch.float32, dev, 1e-6).abs()
    hp = adam_hparams(lr=LR, beta1=0.9, beta2=0.999, eps=1e-8,
                      step=torch.tensor(3, device=dev), weight_decay=0.01,
                      adam_w_mode=True, bias_correction=True, grad_scale=1.0,
                      device=dev)
    nel = p.numel()
    views = [unflatten_tensors(t, spec) for t in (p, g, m, vv2)]
    _entry(res, "gpt_flat_adam",
           time_ms(lambda: mta.flat_adam_kernel(g, p, m, vv2, hp, None,
                                                None), reps=5, inner=3),
           time_ms(lambda: mta.flat_adam_plain(g, p, m, vv2, hp, None, None),
                   reps=5, inner=3),
           time_ms(_fused_adamw(views[:2], views[2], views[3], dev), reps=5,
                   inner=3),
           nel * (4 * 4 + 4 * 3), 16 * nel, FP32_FLOPS,
           f"flat_adam GPT-medium's ({spec.total_rows}, 128) fp32, "
           f"{nel} parameters", "torch._fused_adamw_ over the tree's tensors")
    del p, g, m, vv2, views
    torch.cuda.empty_cache()
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
        ln, fa, xent, fsm, mta, w8, prng = kernel_modules()
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
    build([ln.LIB, fa.LIB, xent.LIB, fsm.LIB, mta.LIB, w8.LIB, prng.LIB])
    err = {"layer_norm_fwd": ln_parity(dev),
           "flash_attention_fwd": flash_parity(dev),
           "layer_norm_bwd": ln_bwd_parity(dev)}
    flash_keep_masks(dev)
    fb = flash_bwd_parity(dev)
    xe = xent_parity(dev)
    sm = softmax_parity(dev)
    sa = flat_scale_axpby_parity(dev)
    lb = flat_lamb_parity(dev)
    err.update(w8_parity(dev))
    err.update(flash_attention_bwd_dq=fb["dq"],
               flash_attention_bwd_dkv=fb["dkv"], xentropy_fwd=xe["fwd"],
               xentropy_bwd=xe["bwd"], scaled_masked_softmax_fwd=sm["fwd"],
               scaled_upper_triang_softmax_fwd=sm["causal"],
               fused_softmax_bwd=sm["bwd"], flat_adam=flat_adam_parity(dev),
               flat_scale=sa["scale"], flat_axpby=sa["axpby"],
               flat_l2norm_partials=lb["l2"], flat_lamb_stage1=lb["stage1"])
    sf = sgd_family_parity(dev)
    err.update(flat_sgd=sf["flat_sgd"], flat_adagrad=sf["flat_adagrad"],
               flat_novograd=sf["flat_novograd"])
    err.update(threefry_parity(dev))
    samp = sampler_parity(dev)
    gk = gpt_kernel_parity(dev)
    for name, key in (("flash_attention_fwd", "fwd"),
                      ("flash_attention_bwd_dq", "dq"),
                      ("flash_attention_bwd_dkv", "dkv"),
                      ("xentropy_fwd", "xent_fwd"),
                      ("xentropy_bwd", "xent_bwd")):
        err[name] = max(err[name], gk[key])
    rope = rope_parity(dev)
    kern = dict(zip(KERNEL_NAMES, (
        ln.LN_FWD, ln.LN_BWD, fa.FLASH_FWD, fa.FLASH_BWD_DQ, fa.FLASH_BWD_DKV,
        xent.XENT_FWD, xent.XENT_BWD, fsm.SOFTMAX_FWD, fsm.SOFTMAX_CAUSAL_FWD,
        fsm.SOFTMAX_BWD, mta.FLAT_ADAM, mta.FLAT_SCALE, mta.FLAT_AXPBY,
        mta.FLAT_L2NORM, mta.FLAT_LAMB_STAGE1, w8.W8_MATMUL_NOBIAS,
        w8.W8_MATMUL, w8.W8_MATMUL_NK, mta.FLAT_SGD, mta.FLAT_ADAGRAD,
        mta.FLAT_NOVOGRAD, prng.THREEFRY_BITS, prng.THREEFRY_DROPOUT)))
    torch.cuda.empty_cache()
    srv = serve(dev, kern)
    srv_rope = serve_rope(dev, kern)
    small = train_small(dev)
    gpt_small = gpt_train_small(dev)
    big = train_big(dev, kern)
    gpt_big = gpt_train_big(dev, kern)
    rn_small = resnet_small(dev)
    rn_big = resnet_big(dev, kern)
    opt = opt_steps(dev, kern)
    pre = pretrain_defaults(dev)
    tm = times(dev)
    tm.update(train_times(dev))
    tm.update(step_times(dev))
    tm.update(flat_times(dev))
    tm.update(w8_times(dev))
    tm.update(sgd_family_times(dev))
    tm.update(threefry_times(dev))
    tm.update(gpt_times(dev))
    by_path = {n: {"serving": srv["bf16"]["launches"][n],
                   "serving_w8": srv["w8"]["launches"][n],
                   "serving_sampled": srv["sampled"]["launches"][n],
                   "serving_rope": srv_rope["launches"][n],
                   "training_dropout": big["fp32 dropout"]["launches"][n]}
               for n in kern}
    for name, res in gpt_big.items():
        for n in kern:
            by_path[n][name] = res["launches"][n]
    for cfg_name in STEP_CONFIGS:
        path = _key(cfg_name, "training").replace(" ", "_")
        for n in kern:
            by_path[n][path] = sum(
                big[_key(cfg_name, m)]["launches"][n]
                for m in ("fp32", "bf16m_castout"))
    for n in kern:
        for name, res in rn_big.items():
            by_path[n][name] = res["launches"][n]
        by_path[n]["optimizer_steps_bert_large"] = sum(
            res["launches"].get(n, 0) for res in opt.values())
    rows = [  # name, source, replaces (TPU kernel file:line), times key
        ("layer_norm_fwd", "layer_norm.cu",
         "normalization/fused_layer_norm.py:76", "ln_1024x1024"),
        ("layer_norm_bwd", "layer_norm.cu",
         "normalization/fused_layer_norm.py:107", "ln_bwd"),
        ("flash_attention_fwd", "flash_attention.cu",
         "transformer/functional/flash_attention.py:239",
         "flash_b1h16s1024d64"),
        ("flash_attention_bwd_dq", "flash_attention.cu",
         "transformer/functional/flash_attention.py:330", "flash_dq"),
        ("flash_attention_bwd_dkv", "flash_attention.cu",
         "transformer/functional/flash_attention.py:395", "flash_dkv"),
        ("xentropy_fwd", "xentropy.cu", "contrib/xentropy.py:38",
         "xent_fwd"),
        ("xentropy_bwd", "xentropy.cu", "contrib/xentropy.py:85",
         "xent_bwd"),
        ("scaled_masked_softmax_fwd", "fused_softmax.cu",
         "transformer/functional/fused_softmax.py:49", "softmax_fwd"),
        ("scaled_upper_triang_softmax_fwd", "fused_softmax.cu",
         "transformer/functional/fused_softmax.py:55", "softmax_causal"),
        ("fused_softmax_bwd", "fused_softmax.cu",
         "transformer/functional/fused_softmax.py:65", "softmax_bwd"),
        ("flat_adam", "multi_tensor.cu",
         "multi_tensor_apply/kernels.py:187", "flat_adam"),
        ("flat_scale", "multi_tensor.cu", "multi_tensor_apply/kernels.py:72",
         "flat_scale"),
        ("flat_axpby", "multi_tensor.cu",
         "multi_tensor_apply/kernels.py:107", "flat_axpby"),
        ("flat_l2norm_partials", "multi_tensor.cu",
         "multi_tensor_apply/kernels.py:146", "flat_l2norm"),
        ("flat_lamb_stage1", "multi_tensor.cu",
         "multi_tensor_apply/kernels.py:287", "flat_lamb_stage1"),
        ("w8_matmul_nobias", "w8_matmul.cu", "quant/kernels.py:96",
         "w8_matmul_nobias_m8"),
        ("w8_matmul", "w8_matmul.cu", "quant/kernels.py:85", "w8_matmul_m8"),
        ("w8_matmul_nk", "w8_matmul.cu", "quant/kernels.py:104",
         "w8_matmul_nk_m8"),
        ("flat_sgd", "multi_tensor.cu", "multi_tensor_apply/kernels.py:216",
         "flat_sgd_resnet50"),
        ("flat_adagrad", "multi_tensor.cu",
         "multi_tensor_apply/kernels.py:401", "flat_adagrad"),
        ("flat_novograd", "multi_tensor.cu",
         "multi_tensor_apply/kernels.py:459", "flat_novograd"),
    ]
    kernels = [dict(name=name, route="cuda",
                    source=f"apex_tpu_torch/csrc/{src}",
                    replaces=f"apex_tpu/{rep}",
                    launches=sum(by_path[name].values()),
                    launches_by_path=by_path[name],
                    max_abs_err=err[name], **tm[key])
               for name, src, rep, key in rows]
    # port kernels with no Pallas counterpart: the JAX package draws these
    # bits through jax.random, which XLA expands into integer ops
    kernels += [dict(
        name=name, route="cuda", source="apex_tpu_torch/csrc/threefry.cu",
        replaces=rep, tpu_row=None, launches=sum(by_path[name].values()),
        launches_by_path=by_path[name], max_abs_err=err[name], **tm[key],
        **{k: tm[x] for k, x in extra.items()}, note=note)
        for name, rep, key, extra, note in (
            ("threefry_bits",
             "jax/_src/prng.py:1184 (_threefry_random_bits_partitionable; "
             "the sampler's jax.random.categorical, "
             "apex_tpu/serving/sampling.py:70)", "threefry_bits_8x50304",
             {"at_bert_hidden_one_key": "threefry_bits_hidden"},
             "threefry2x32-20 words, one key a row (the decode tick's 8 "
             "slots), 20 rounds of add, funnel shift and xor in registers; "
             "bound by the integer ALU's funnel shifts and xors"),
            ("threefry_dropout",
             "apex_tpu/models/bert.py:149 (_maybe_dropout: x * "
             "jax.random.bernoulli(key, 1 - rate, x.shape) / (1 - rate))",
             "threefry_dropout_hidden",
             {"at_unfused_probs": "threefry_dropout_probs"},
             "the mask's bits, uniform and compare in registers, never "
             "stored; the backward regenerates it from the key (a second "
             "launch on the gradient); 16-byte loads and stores"))]
    kernels[KERNEL_NAMES.index("scaled_upper_triang_softmax_fwd")].update(
        redesigned=True,
        note="the masked forward's kernel with the causal mask k > q from "
        "the 32-bit query; on no model path: reached only through "
        "FusedScaleMaskSoftmax(attn_mask_type=causal); held to its plain "
        "version and timed at (16, 1024, 1024) bf16")
    for name in ("flat_scale", "flat_axpby"):
        kernels[KERNEL_NAMES.index(name)]["note"] = (
            "on no model path; the JAX package reaches them only from its "
            "lint tiers (apex_tpu/lint/traced/registry.py:1234-1237)")
    w8_design = (
        "one launch at M <= 8 (x fp32 or bf16): a gemv whose last block of "
        "a column strip, by an integer arrival counter, sums the K parts "
        "in part order (no float atomics; the counters reset by that "
        "block, so CUDA-graph replays find them zero); bf16 x at M > 8 on "
        "the tensor cores: mma.sync.m16n8k16 bf16 -> fp32 over 64 x 64 "
        "tiles, 16-byte cp.async rings, the int8 weights kept int8 in "
        "shared memory and widened in registers after ldmatrix.trans, "
        "y = s_n * sum_k x q + b (exact products, one scale multiply); fp32 "
        "x at M > 8 keeps the CUDA-core tile")
    kernels[KERNEL_NAMES.index("w8_matmul_nobias")].update(
        redesigned=True, note=w8_design + "; on no unsharded path: only the "
        "tensor-parallel row-parallel linear calls it "
        "(apex_tpu/serving/decode.py:880); held to its plain version and "
        "timed at K 4096, N 1024")
    kernels[KERNEL_NAMES.index("w8_matmul")].update(redesigned=True,
                                                    note=w8_design)
    for k in (kernels[KERNEL_NAMES.index(n)] for n in (
            "w8_matmul_nobias", "w8_matmul", "w8_matmul_nk")):
        # the w8 rows: times at M 8, and M 1024 here
        k.update(at_m1024=tm[k["name"] + "_m1024"],
                 library_call=tm["w8_library"])
        # rows 21-22 also at the smallest prefill bucket, row 23 at a
        # prefill's M 1 (the logits of its last real token)
        extra = "_m1" if k["name"] == "w8_matmul_nk" else "_m128"
        k["at" + extra] = tm[k["name"] + extra]
    kernels[KERNEL_NAMES.index("w8_matmul_nk")].update(
        redesigned=True,
        note="bf16 x at M <= 8 on the tensor cores with the operands "
        "swapped: y^T = Wq . x^T by mma.sync.m16n8k16 bf16 -> fp32, 16 "
        "output channels the A rows, x's rows (zeros past M) the 8 B "
        "columns; each lane reads 16 contiguous bytes of each of its two "
        "int8 rows (coalesced, a stage of 256 bytes a row ahead of its "
        "use), widens them in registers without conversion instructions, "
        "and takes x's bf16 pairs at the same permuted k from a copy "
        "staged once a block in shared memory; y = s_n * sum_k x q; K "
        "not split (no scratch, no counters), a contiguous run of "
        "16-channel tiles a block, two blocks an SM; fp32 x keeps the "
        "CUDA-core gemv, M > 8 the CUDA-core tile")
    kernels[KERNEL_NAMES.index("xentropy_bwd")].update(
        redesigned=True,
        note="rebuilt for the bytes: a persistent grid (SMs x the blocks an "
        "SM holds) walking the rows with no barrier, each row's label, lse "
        "and dloss read once, a row ahead; 16-byte streaming loads (4 "
        "vectors a thread in flight) and stores from a 256-byte block of "
        "the row, a scalar head and tail around them; 32-bit columns; the "
        "label column patched in its one vector; an ignored row a zero "
        "stream; the parent's operations in its order (the same bits)")
    kernels[KERNEL_NAMES.index("scaled_masked_softmax_fwd")].update(
        redesigned=True,
        note="rebuilt for the bytes: a block's rows share one (batch, "
        "head) from the grid (no per-row 64-bit division), the row held "
        "in registers in 16-byte vectors, the mask's values of a vector "
        "read in one load where its key stride is 1, one correctly "
        "rounded reciprocal of the row sum and a multiply a score")
    kernels[KERNEL_NAMES.index("layer_norm_fwd")].update(
        redesigned=True,
        note="built for the bytes: a team of 32-1024 threads a row, 8 "
        "columns a thread up to 2^21 elements and 32 beyond, 16-byte loads "
        "of x, w and b and stores of y, the row held in registers from the "
        "load to the store (one read of device memory), warp shuffles and, "
        "for a team of several warps, the warps' sums in warp order; "
        "element loads where h or a row base is not aligned",
        at_8x1024=tm["ln_8x1024"], at_8192x1024_fp32_w=tm["ln_fwd_train"])
    kernels[KERNEL_NAMES.index("flat_sgd")].update(
        at_bert_large=tm["flat_sgd_bert"],
        bf16_buf_castout=tm["flat_sgd_resnet50_bf16buf_castout"])
    design = ("mma.sync.m16n8k16 bf16 tensor cores (fp32 accumulators), "
              "ldmatrix fragments, 16-byte cp.async double-buffered tiles "
              "(element loads where rows are not 16-byte aligned); fp32 "
              "keeps the CUDA-core kernel")
    kernels[KERNEL_NAMES.index("flash_attention_fwd")].update(
        redesigned=True, note=design,
        at_bert_views=tm["flash_fwd_train"],
        at_gpt_views=tm["flash_b1h16s1024d64_gpt_views"])
    kernels[KERNEL_NAMES.index("flash_attention_bwd_dkv")].update(
        redesigned=True, note=design)
    kernels[KERNEL_NAMES.index("flash_attention_bwd_dq")].update(
        redesigned=True, note=design + "; one block a 64-row q tile, S = "
        "q~ K^T and dP = do V^T in registers, ds packed in place as the A "
        "fragment of dq += dS K (K through ldmatrix.trans); each dq "
        "element written once, no atomics")
    kernels[KERNEL_NAMES.index("layer_norm_bwd")].update(
        redesigned=True,
        note="two stages built for the bytes: stage 1 one 512-thread block "
        "an SM (grid from the SM count), a team of 32-512 threads a row, "
        "16-byte loads of dy and x and stores of dx, the row held in "
        "registers between the statistics and dx passes with the next "
        "row in flight, c1/c2 by warp shuffles and the team's named "
        "barrier, one fp32 partial row of dgamma and of dbeta a block; "
        "stage 2 sums the partial rows per column in a fixed order with "
        "coalesced 128-byte reads; no float atomics",
        at_2048x4096=tm["ln_bwd_4096"])
    # GPT-medium's training step (gpt_tp_bench's tp=1 shape): the
    # LayerNorm's (8192, 1024) bf16 x, fp32 w and the dropout's 8.4M bf16
    # elements are the BERT step's shapes, timed above
    for name, key in (("layer_norm_fwd", "ln_fwd_train"),
                      ("layer_norm_bwd", "ln_bwd"),
                      ("flash_attention_fwd", "gpt_flash_fwd"),
                      ("flash_attention_bwd_dq", "gpt_flash_dq"),
                      ("flash_attention_bwd_dkv", "gpt_flash_dkv"),
                      ("xentropy_fwd", "gpt_xent_fwd"),
                      ("xentropy_bwd", "gpt_xent_bwd"),
                      ("flat_adam", "gpt_flat_adam")):
        kernels[KERNEL_NAMES.index(name)]["at_gpt_train"] = tm[key]
    kernels[KERNEL_NAMES.index("threefry_dropout")]["at_gpt_train"] = \
        tm["threefry_dropout_hidden"]
    for name in ("flat_adagrad", "flat_novograd"):
        kernels[KERNEL_NAMES.index(name)]["note"] = (
            "on no model path of the JAX package: driven through its "
            "optimizer's flat step on BERT-Large's parameter set "
            "(launches_by_path optimizer_steps_bert_large)")
    check(all(sum(by_path[n].values()) > 0 for n in KERNEL_NAMES
              if n not in OFF_PATH),
          "every kernel of a path launched on that path")
    for key in ("ln_8x1024", "ln_fwd_train", "ln_bwd_4096",
                "flash_fwd_train", "flash_b1h16s1024d64_gpt_views",
                "flat_adam_bf16m_castout",
                "flat_lamb_stage1_bf16m", "flat_sgd_bert_bf16buf_castout",
                "w8_matmul_m1024", "w8_matmul_m128",
                "w8_matmul_nobias_m1024", "w8_matmul_nobias_m128",
                "w8_matmul_nk_m1024", "w8_matmul_nk_m1",
                "threefry_bits_hidden", "threefry_dropout_probs"):
        print(f"{key}: {json.dumps(tm[key])}")
    print(f"sampler parity: {json.dumps(samp)}")
    print(f"serving: {json.dumps(srv)}")
    print(f"training, card vs CPU: {json.dumps(small)}")
    print(f"training, BERT-Large: {json.dumps(big)}")
    print(f"ResNet, card vs CPU: {json.dumps(rn_small)}")
    print(f"ResNet-50 training: {json.dumps(rn_big)}")
    print(f"optimizer steps on BERT-Large's parameter set: "
          f"{json.dumps(opt)}")
    for key in ("gpt_flash_fwd", "gpt_flash_dq", "gpt_flash_dkv",
                "gpt_xent_fwd", "gpt_xent_bwd", "gpt_flat_adam"):
        print(f"{key}: {json.dumps(tm[key])}")
    print(f"RoPE: {json.dumps(rope)}")
    print(f"serving_rope: {json.dumps(srv_rope)}")
    print(f"GPT training, card vs CPU: {json.dumps(gpt_small)}")
    print(f"GPT-medium training: {json.dumps(gpt_big)}")
    print(f"pretrain_gpt losses: {json.dumps(pre)}")
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Where two paged attention kernels' serving streams part, and how near
a tie each parting is, in one process on one card.

Runs ``chip_smoke.py``'s paged serving mixes (GPT-2 medium, random
weights from seed 0, O2 bf16, ``PagedDecodeEngine`` with 8 slots,
max_len 1024 and pages of 64, after the same one-request warm-up) three
times: on this checkout's ``csrc/paged_attention.cu``, on another
checkout's (built with the same flags and swapped in under this
checkout's wrappers, as ``examples/kernel_ab.py`` does) and on the
wrappers' plain versions run on the card (the gather the JAX package
does). Every committed token's logits row is kept, with its
temperature and sampling key.

For each pair of runs it prints one JSON line: the tokens they share,
and over every committed token whose request had the same history in
both (the tokens before it equal), the largest absolute logit
difference between the two rows (median, 99th percentile, maximum).
For each request whose streams part, one line at the first token that
differs: both tokens, each run's decision margin between them (the
logits for a greedy request; logits / T plus the row's Gumbel noise
for a sampled one, the sampler's own scores), the row's largest logit
difference, and the plain run's margin and token where its history is
the same. A parting whose margins are below the row's logit
difference is a near-tie that the sums' order decides.

    python -m apex_tpu_torch.examples.gpt.stream_ab --other DIR \\
        [--mix paged ngram adaptive ngram_k64]

``paged`` is ``serving_paged``'s greedy mix; ``ngram``, ``adaptive``
and ``ngram_k64`` are ``serving_spec``'s runs of those names (the motif
mix, half sampled at 0.8, ``spec_k`` 4, the adaptive depth, ``spec_k``
64).
"""

import argparse
import json
import os
import subprocess
import sys

import torch

_MIXES = ("paged", "ngram", "adaptive", "ngram_k64")


def _mix(name):
    """(prompts, temperatures or None, engine keywords) of a mix."""
    import chip_smoke as cs
    from apex_tpu_torch.models.gpt import gpt_medium

    cfg = gpt_medium()
    if name == "paged":
        return cs.mix_prompts(cfg), None, {}
    spec = {"ngram": dict(spec_k=cs.SPEC_K),
            "adaptive": dict(spec_k=cs.SPEC_K, adaptive_spec=True),
            "ngram_k64": dict(spec_k=cs.SPEC_K_WIDE)}[name]
    return cs.spec_prompts(cfg), cs.SPEC_TEMPS, spec


def serve(params, cfg, dev, prompts, temps, engine_kw):
    """The mix on a new paged engine, after ``serve_mix``'s warm-up.
    Returns the streams and {(request, token index): (logits row,
    temperature, key)} of every committed token."""
    import chip_smoke as cs
    from apex_tpu_torch.serving import (ContinuousBatchingScheduler,
                                        PagedDecodeEngine, Request)

    eng = PagedDecodeEngine(params, cfg, num_slots=cs.NUM_SLOTS,
                            max_len=cs.MAX_LEN, cache_dtype=torch.bfloat16,
                            buckets=cs.BUCKETS, device=dev,
                            num_pages=cs.PAGED_POOL, page_size=cs.PAGE,
                            **engine_kw)
    warm = ContinuousBatchingScheduler(eng, eos_id=-1)
    warm.submit(Request(prompt=(1, 2, 3), max_new_tokens=2))
    warm.run()
    sched = ContinuousBatchingScheduler(eng, eos_id=-1)
    for i, prompt in enumerate(prompts):
        sched.submit(Request(prompt=prompt, max_new_tokens=cs.NEW_TOKENS,
                             temperature=0.0 if temps is None else temps[i],
                             seed=i))
    rows = cs.capture_rows(eng, sched)
    streams = sched.run()
    torch.cuda.synchronize()
    return streams, rows


def _plain(pa):
    """The module's kernel entries replaced by their plain versions (on
    the card's tensors); returns the originals."""
    saved = (pa.paged_decode_attention_kernel,
             pa.paged_verify_attention_kernel)

    def decode(q, k, v, bt, pos, ks=None, vs=None, softmax_scale=None):
        return pa.paged_decode_attention_plain(q, k, v, bt, pos, ks, vs,
                                               softmax_scale)

    def verify(q, k, v, bt, pos, anc=None, ks=None, vs=None,
               softmax_scale=None, q0=0, nq=None, out=None):
        nq = q.shape[2] - q0 if nq is None else nq
        got = pa.paged_verify_attention_plain(q, k, v, bt, pos, anc, ks, vs,
                                              softmax_scale, q0=q0, nq=nq)
        out = torch.empty_like(q) if out is None else out
        out[:, :, q0:q0 + nq] = got
        return out

    pa.paged_decode_attention_kernel = decode
    pa.paged_verify_attention_kernel = verify
    return saved


def compare(mix, runs, a, b):
    """The JSON lines of runs ``a`` and ``b`` (see the module's note)."""
    import chip_smoke as cs

    sa, ra = runs[a]
    sb, rb = runs[b]
    diffs, lines = [], []
    for rid, (xa, xb) in enumerate(zip(sa, sb)):
        part = next((t for t, (u, w) in enumerate(zip(xa, xb)) if u != w),
                    None)
        for t in range(len(xa) if part is None else part + 1):
            diffs.append(float((ra[(rid, t)][0] - rb[(rid, t)][0]).abs()
                               .max()))
        if part is None:
            continue
        ta, tb = xa[part], xb[part]
        row_a, temp, key = ra[(rid, part)]
        za = cs.decision_scores(row_a, temp, key)
        zb = cs.decision_scores(rb[(rid, part)][0], temp, key)
        line = dict(mix=mix, runs=f"{a}-{b}", request=rid, token=part,
                    temperature=temp, tokens={a: ta, b: tb},
                    margin={a: float(za[ta] - za[tb]),
                            b: float(zb[tb] - zb[ta])},
                    max_abs_logit_diff=diffs[-1])
        if "plain" in runs and "plain" not in (a, b):
            sp, rp = runs["plain"]
            if sp[rid][:part] == xa[:part]:
                zp = cs.decision_scores(rp[(rid, part)][0], temp, key)
                line.update(plain_token=sp[rid][part],
                            plain_margin_a_over_b=float(zp[ta] - zp[tb]))
        lines.append(line)
    d = torch.tensor(diffs)
    head = dict(mix=mix, runs=f"{a}-{b}", tokens_equal=sum(
        u == w for xa, xb in zip(sa, sb) for u, w in zip(xa, xb)),
        tokens=sum(len(x) for x in sa), rows_compared=len(diffs),
        max_abs_logit_diff={"median": float(d.median()),
                            "p99": float(d.quantile(0.99)),
                            "max": float(d.max())},
        streams_parted=len(lines))
    return [head] + lines


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True,
                    help="root of the checkout whose paged attention to "
                    "serve against this one's")
    ap.add_argument("--mix", nargs="+", default=list(_MIXES),
                    choices=_MIXES)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("stream_ab: no CUDA device", file=sys.stderr)
        return 2
    from apex_tpu_torch import amp
    from apex_tpu_torch.examples.kernel_ab import _swapped
    from apex_tpu_torch.models.gpt import gpt_medium, init_gpt
    from apex_tpu_torch.transformer.functional import paged_attention
    from apex_tpu_torch.utils.cuda_build import CudaLibrary, build_all

    pa = paged_attention
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    print(json.dumps({"card": card, "torch": torch.__version__}),
          flush=True)
    other = CudaLibrary("paged_attention")
    other.name = "paged_attention_other"
    other.source = os.path.join(os.path.abspath(args.other), "apex_tpu_torch",
                                "csrc", "paged_attention.cu")
    build_all([pa.LIB, other])
    cfg = gpt_medium()
    with torch.inference_mode():
        params = amp.initialize("O2", verbosity=0).cast_model(
            init_gpt(cfg, torch.Generator().manual_seed(0), device=dev))
        for mix in args.mix:
            prompts, temps, kw = _mix(mix)

            def run():
                return serve(params, cfg, dev, prompts, temps, kw)

            runs = {"this": run(),
                    "other": _swapped({"paged_attention": other}, run,
                                      "paged_attention")()}
            saved = _plain(pa)
            try:
                runs["plain"] = run()
            finally:
                (pa.paged_decode_attention_kernel,
                 pa.paged_verify_attention_kernel) = saved
            for a, b in (("this", "other"), ("this", "plain"),
                         ("other", "plain")):
                for line in compare(mix, runs, a, b):
                    print(json.dumps(line), flush=True)
            del runs
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""KV-cached GPT generation CLI for the PyTorch/CUDA port — drives
``apex_tpu_torch.serving`` end to end: bf16 inference params (``amp``
O2 model cast), a preallocated KV cache updated in place, bucketed
prefill, and continuous batching over a fixed slot set with greedy or
temperature/top-k sampling.

Synthetic weights and prompts. Runs on the CUDA device by default::

    python -m apex_tpu_torch.examples.gpt.generate --num-requests 8 \\
        --num-slots 4 --max-new-tokens 24 --temperature 0.8 --top-k 50

and on the CPU (the kernels' plain versions) with ``--device cpu``;
``--use-rope`` gives the model rotary positions in place of the learned
table.
Explicit prompts as comma-separated token ids::

    python -m apex_tpu_torch.examples.gpt.generate --prompt 5,7,11 \\
        --prompt 42,1,2,3
"""

import argparse
import time

import numpy as np
import torch

from apex_tpu_torch import amp
from apex_tpu_torch.models.gpt import GPTConfig, init_gpt
from apex_tpu_torch.serving import (
    ContinuousBatchingScheduler, DecodeEngine, Request,
)
from apex_tpu_torch.utils.platform import resolve_device


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    m = p.add_argument_group("model")
    m.add_argument("--vocab-size", type=int, default=512)
    m.add_argument("--hidden-size", type=int, default=64)
    m.add_argument("--num-layers", type=int, default=4)
    m.add_argument("--num-heads", type=int, default=8)
    m.add_argument("--ffn-hidden-size", type=int, default=128)
    m.add_argument("--use-rope", action="store_true")
    m.add_argument("--fp32", action="store_true",
                   help="skip the O2 bf16 model cast (and use an fp32 "
                        "KV cache)")
    s = p.add_argument_group("serving")
    s.add_argument("--num-slots", type=int, default=4)
    s.add_argument("--max-len", type=int, default=128)
    s.add_argument("--top-k", type=int, default=0)
    s.add_argument("--device", default=None,
                   help="'cuda' (the default) or 'cpu'")
    r = p.add_argument_group("requests")
    r.add_argument("--prompt", action="append", default=None,
                   help="comma-separated token ids; repeatable. Default: "
                        "--num-requests random prompts")
    r.add_argument("--num-requests", type=int, default=8)
    r.add_argument("--max-new-tokens", type=int, default=16)
    r.add_argument("--temperature", type=float, default=0.0)
    r.add_argument("--eos-id", type=int, default=1)
    r.add_argument("--seed", type=int, default=0)
    return p.parse_args(argv)


def main(argv=None):
    ns = parse_args(argv)
    device = resolve_device(ns.device)
    cfg = GPTConfig(
        vocab_size=ns.vocab_size, hidden_size=ns.hidden_size,
        num_layers=ns.num_layers, num_heads=ns.num_heads,
        ffn_hidden_size=ns.ffn_hidden_size,
        max_position_embeddings=ns.max_len, use_rope=ns.use_rope,
        hidden_dropout=0.0)
    params = init_gpt(cfg, torch.Generator().manual_seed(ns.seed),
                      device=device)
    if not ns.fp32:
        params = amp.initialize("O2", verbosity=0).cast_model(params)
    cache_dtype = torch.float32 if ns.fp32 else torch.bfloat16

    engine = DecodeEngine(params, cfg, num_slots=ns.num_slots,
                          max_len=ns.max_len, cache_dtype=cache_dtype,
                          top_k=ns.top_k, device=device)
    sched = ContinuousBatchingScheduler(engine, eos_id=ns.eos_id)

    if ns.prompt:
        prompts = [tuple(int(t) for t in s.split(",")) for s in ns.prompt]
    else:
        rng = np.random.RandomState(ns.seed)
        prompts = [
            tuple(int(t) for t in rng.randint(
                2, cfg.vocab_size, size=rng.randint(4, ns.max_len // 2)))
            for _ in range(ns.num_requests)]
    for i, prompt in enumerate(prompts):
        sched.submit(Request(prompt=prompt,
                             max_new_tokens=ns.max_new_tokens,
                             temperature=ns.temperature,
                             seed=ns.seed + i))

    t0 = time.perf_counter()
    with torch.inference_mode():
        outputs = sched.run()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    n_tok = sum(len(o) for o in outputs)
    for i, (prompt, out) in enumerate(zip(prompts, outputs)):
        print(f"[{i}] prompt({len(prompt)})={list(prompt)[:8]}... "
              f"-> {out}")
    print(f"generated {n_tok} tokens across {len(outputs)} requests "
          f"in {dt:.2f}s ({n_tok / dt:.1f} tok/s) on {device.type}")


if __name__ == "__main__":
    main()

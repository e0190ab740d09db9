"""Time ``chip_smoke.py``'s ``serving_paged_tiered`` phase (four
512-token prefixes cycling over two slots on 2 + 40 pages with a host
spill tier; an int8 and a bf16 pool, and the int8 mix without a tier on
the same and on a roomy pool; GPT-2 medium O2, random weights from seed
0), or with ``--phase chunked`` its ``serving_chunked`` phase (the
serving mix open-loop, chunked at 256 and monolithic, on the paged and
the dense engine), in this checkout against another checkout, on one
card.

    python -m apex_tpu_torch.examples.gpt.tiered_ab --other DIR \
        [--phase tiered|chunked] [--logs DIR]

Run it from the root of the repository. ``DIR`` is the root of another
checkout whose ``chip_smoke.py`` has the same ``serve_tiered(dev, kern,
o2)`` and ``serve_chunked(dev, kern, o2)``. Each run is a process of its own in its checkout's root (its
kernels built from its own sources into its own build directory), in
turns: this, other, other, this. A run's whole output goes to
``--logs``; this script prints, for each run, its checkout and the wall
seconds, tokens and tokens/s of each of the phase's four runs, one JSON
object a run, the card's name and power limit first.
"""

import argparse
import json
import os
import subprocess
import sys

_RUN = r'''
import json, torch
import chip_smoke as cs
from apex_tpu_torch import amp
from apex_tpu_torch.models.gpt import gpt_medium, init_gpt

dev = torch.device("cuda", 0)
torch.cuda.set_device(dev)
ln, fa, xent, fsm, mta, w8, prng, pa = cs.kernel_modules()
cs.build([ln.LIB, fa.LIB, xent.LIB, fsm.LIB, mta.LIB, w8.LIB, prng.LIB,
          pa.LIB])
kern = dict(zip(cs.KERNEL_NAMES, (
    ln.LN_FWD, ln.LN_BWD, fa.FLASH_FWD, fa.FLASH_BWD_DQ, fa.FLASH_BWD_DKV,
    xent.XENT_FWD, xent.XENT_BWD, fsm.SOFTMAX_FWD, fsm.SOFTMAX_CAUSAL_FWD,
    fsm.SOFTMAX_BWD, mta.FLAT_ADAM, mta.FLAT_SCALE, mta.FLAT_AXPBY,
    mta.FLAT_L2NORM, mta.FLAT_LAMB_STAGE1, w8.W8_MATMUL_NOBIAS,
    w8.W8_MATMUL, w8.W8_MATMUL_NK, mta.FLAT_SGD, mta.FLAT_ADAGRAD,
    mta.FLAT_NOVOGRAD, prng.THREEFRY_BITS, prng.THREEFRY_DROPOUT,
    pa.PAGED_DECODE, pa.PAGED_VERIFY) + tuple(
        getattr(pa, n) for n in ("PAGED_CHUNK",) if hasattr(pa, n))))
params = init_gpt(gpt_medium(), torch.Generator().manual_seed(0), device=dev)
with torch.inference_mode():
    o2 = amp.initialize("O2", verbosity=0).cast_model(params)
del params
out = getattr(cs, "serve_" + PHASE)(dev, kern, o2)
print("RESULT " + json.dumps({
    k: {f: v[f] for f in ("wall_s", "tokens", "tokens_per_s")}
    for k, v in out.items() if isinstance(v, dict) and "wall_s" in v}))
'''


def run(root, label, logs, i, phase):
    """One run of the phase in ``root``; its readings, or its exit code
    and the log's path when it failed."""
    log = os.path.join(logs, f"{phase}_ab_{i}_{label}.log")
    with open(log, "w") as f:
        proc = subprocess.run(
            [sys.executable, "-c", f"PHASE = {phase!r}\n" + _RUN],
            cwd=root, stdout=f, stderr=subprocess.STDOUT)
    res = None
    with open(log) as f:
        for line in f:
            if line.startswith("RESULT "):
                res = json.loads(line[len("RESULT "):])
    return dict(run=i, checkout=label, root=root, rc=proc.returncode,
                log=log, mixes=res)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", required=True,
                    help="root of the checkout to compare with")
    ap.add_argument("--phase", choices=("tiered", "chunked"),
                    default="tiered", help="the chip_smoke.py phase timed")
    ap.add_argument("--logs", default="chiprun_out",
                    help="directory for each run's whole output")
    args = ap.parse_args(argv)
    os.makedirs(args.logs, exist_ok=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip(), flush=True)
    this, other = os.getcwd(), os.path.abspath(args.other)
    failed = False
    for i, (label, root) in enumerate((("this", this), ("other", other),
                                       ("other", other), ("this", this))):
        res = run(root, label, args.logs, i, args.phase)
        failed |= res["rc"] != 0 or res["mixes"] is None
        print(json.dumps(res), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())

"""Command-line entry point: ``python -m apex_tpu_torch.lint [paths...]``
(default ``apex_tpu_torch``).

Exit status is 0 when every check passes, 1 when any finding survives
suppression, 2 on a usage error — suitable as a blocking CI step.
``--determinism`` adds the APX8xx tier over the serving scope;
``--select`` narrows the *output* to a comma-separated code list;
``--codes APX80*,APX106`` instead names the checks to *run* — globs
expand against the catalogue and the owning tier is enabled (APX8xx
turns on ``--determinism``). ``--list-codes`` prints the catalogue,
ported codes and the codes still owed to later ROADMAP items alike.

The JAX package's ``--no-trace``, ``--trace``, ``--cost``,
``--sharding`` and ``--scaling`` select tiers the port has not ported
yet (``engine`` module doc), so the port's CLI has no such flags; a
``--codes`` pattern that names only their codes exits 2 naming the
ROADMAP item that ports them.
"""

import argparse
import fnmatch
import sys

from apex_tpu_torch.lint import CODES, PENDING
from apex_tpu_torch.lint.engine import lint_paths


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m apex_tpu_torch.lint",
        description="apxlint for the PyTorch/CUDA port — static contract "
                    "checker for quantization numerics, collectives, "
                    "AMP op lists, graph/compile/recompute hygiene and "
                    "serving determinism.")
    ap.add_argument("paths", nargs="*", default=["apex_tpu_torch"],
                    help="files or directories to lint "
                         "(default: apex_tpu_torch)")
    ap.add_argument("--determinism", action="store_true",
                    help="also run the APX8xx determinism tier: "
                         "tick-path ordering/RNG/clock discipline, "
                         "fault-contract coverage, error-taxonomy "
                         "closure, and observe-name coherence over "
                         "the serving stack")
    ap.add_argument("--select", default=None, metavar="CODES",
                    help="comma-separated codes to report "
                         "(e.g. APX106,APX201)")
    ap.add_argument("--codes", default=None, metavar="GLOBS",
                    help="run a named subset of checks: comma-separated "
                         "codes or globs expanded against the catalogue "
                         "(e.g. APX80*,APX106); APX8xx enables "
                         "--determinism, and only the matched codes are "
                         "reported")
    ap.add_argument("--include-fixtures", action="store_true",
                    help="also lint files marked '# apxlint: fixture'")
    ap.add_argument("--list-codes", action="store_true",
                    help="print the error-code catalogue and exit")
    args = ap.parse_args(argv)

    if args.list_codes:
        for code, doc in sorted(CODES.items()):
            print(f"{code}  {doc}")
        return 0

    select = None
    if args.select:
        select = {c.strip().upper() for c in args.select.split(",") if
                  c.strip()}
        unknown = select - set(CODES)
        if unknown:
            print(f"unknown codes: {', '.join(sorted(unknown))}",
                  file=sys.stderr)
            return 2

    if args.codes:
        chosen = set()
        for pat in (p.strip().upper() for p in args.codes.split(",")):
            if not pat:
                continue
            hits = fnmatch.filter(CODES, pat)
            if not hits:
                print(f"--codes pattern {pat!r} matches no known code "
                      f"(see --list-codes)", file=sys.stderr)
                return 2
            chosen.update(hits)
        owed = sorted(c for c in chosen if c in PENDING)
        chosen -= set(owed)
        if not chosen:
            items = sorted({PENDING[c] for c in owed})
            print(f"--codes {args.codes}: not ported yet (ROADMAP "
                  f"{', '.join(items)})", file=sys.stderr)
            return 2
        if any(c.startswith("APX8") for c in chosen):
            args.determinism = True
        select = chosen if select is None else (select & chosen)

    findings, n_files = lint_paths(args.paths or ["apex_tpu_torch"],
                                   include_fixtures=args.include_fixtures,
                                   determinism=args.determinism,
                                   select=select)
    for f in findings:
        print(f.render())
    tail = f"{n_files} file(s) checked"
    if findings:
        print(f"apxlint: {len(findings)} finding(s), {tail}",
              file=sys.stderr)
        return 1
    print(f"apxlint: clean, {tail}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Profiling hooks and the trace report (counterpart of
``apex_tpu/utils/profiler.py``; reference: ``pyprof`` / nvprof markers
and ``torch.cuda.nvtx`` ranges, and ``apex/pyprof``'s parsed op tables).

- :func:`annotate` is ``torch.profiler.record_function``: a named range
  on the trace's host lanes (the JAX package's ``jax.named_scope``).
- :func:`trace` runs ``torch.profiler.profile`` over its block, with the
  CPU activity and, where CUDA is available, the CUDA activity, and
  writes a gzipped Chrome trace to
  ``<log_dir>/plugins/profile/<run>/<host>.trace.json.gz``: the layout
  ``jax.profiler.trace`` writes and :func:`summarize_trace` reads.
- :func:`summarize_trace` and :func:`print_summary` aggregate the newest
  run into per-name totals.

The device lanes differ from the JAX package's. There they are the
trace's processes whose name holds ``/device``; in a torch trace the
device's work is the events of category ``kernel``, ``gpu_memcpy`` and
``gpu_memset`` (CUPTI's records of kernels, copies and sets), which
``device_only`` keeps. A CUDA library loaded inside a profiler session
leaves later sessions without device events, so run the traced work once
before :func:`trace` (the kernels' libraries load at their first
launch); a trace of the CPU holds host events only.

Typical use::

    from apex_tpu_torch.utils.profiler import annotate, trace
    step(*state)                 # once outside: loads the kernels
    with trace("/tmp/tb"):
        with annotate("train_step"):
            state = step(*state)
    print_summary("/tmp/tb")
"""

import contextlib
import glob
import gzip
import json
import os
import shutil
import socket
import time
from typing import Dict, List, Optional

import torch

annotate = torch.profiler.record_function

# the trace's categories of device work (CUPTI's kernel, copy and set
# records)
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


@contextlib.contextmanager
def trace(log_dir: str, *, create_perfetto_link: bool = False):
    """Capture a host (and, with CUDA, device) profile of the block
    under ``log_dir``. ``create_perfetto_link`` is the JAX signature's
    and has no counterpart here: it is accepted and does nothing."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    run = os.path.join(log_dir, "plugins", "profile",
                       time.strftime("%Y_%m_%d_%H_%M_%S")
                       + f"_{time.time_ns() % 10 ** 9:09d}")
    os.makedirs(run, exist_ok=True)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    try:
        yield
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        raw = os.path.join(run, f"{socket.gethostname()}.trace.json")
        prof.export_chrome_trace(raw)
        with open(raw, "rb") as src, gzip.open(raw + ".gz", "wb") as dst:
            shutil.copyfileobj(src, dst)
        os.unlink(raw)


def _is_device(event: dict) -> bool:
    return event.get("cat") in DEVICE_CATEGORIES


def summarize_trace(log_dir: str, *, top: int = 20,
                    device_only: bool = True) -> List[Dict]:
    """Aggregate the newest trace under ``log_dir`` into per-name totals.

    Returns rows ``{"name", "process", "count", "total_us", "avg_us"}``
    sorted by total duration, descending. ``device_only`` keeps only
    the device's work (kernels, copies and sets); pass False to include
    the host's events (operators, Python and runtime calls, ranges)."""
    runs = sorted(glob.glob(os.path.join(log_dir, "plugins", "profile",
                                         "*")))
    if not runs:
        raise FileNotFoundError(f"no profile runs under {log_dir}")
    paths = glob.glob(os.path.join(runs[-1], "*.trace.json.gz"))
    if not paths:
        raise FileNotFoundError(
            f"profile run {runs[-1]} has no *.trace.json.gz (the trace "
            "was not written: the traced block did not finish)")
    agg: Dict[tuple, Dict] = {}
    for path in paths:
        with gzip.open(path, "rt") as f:
            doc = json.load(f)
        events = doc["traceEvents"] if isinstance(doc, dict) else doc
        pids = {e["pid"]: e.get("args", {}).get("name", str(e["pid"]))
                for e in events
                if e.get("ph") == "M" and e.get("name") == "process_name"}
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            if device_only and not _is_device(e):
                continue
            proc = pids.get(e.get("pid"), str(e.get("pid")))
            key = (proc, e["name"].lstrip("$"))
            row = agg.setdefault(key, {"name": key[1], "process": proc,
                                       "count": 0, "total_us": 0.0})
            row["count"] += 1
            row["total_us"] += float(e["dur"])
    if not agg and device_only:
        raise ValueError(
            "trace has no device lanes (CPU-only traces record host "
            "events only) — pass device_only=False to summarize host "
            "Python/dispatch events")
    rows = sorted(agg.values(), key=lambda r: -r["total_us"])[:top]
    for r in rows:
        r["avg_us"] = r["total_us"] / max(r["count"], 1)
    return rows


def print_summary(log_dir: str, *, top: int = 20,
                  device_only: bool = True,
                  file: Optional[object] = None) -> None:
    """Print :func:`summarize_trace` as a fixed-width table (the
    pyprof-style report)."""
    rows = summarize_trace(log_dir, top=top, device_only=device_only)
    print(f"{'total_us':>12} {'avg_us':>10} {'count':>7}  name",
          file=file)
    for r in rows:
        print(f"{r['total_us']:>12.1f} {r['avg_us']:>10.1f} "
              f"{r['count']:>7d}  {r['name'][:90]}", file=file)

"""Port parity of ``utils/profiler.py``, the reference's
``tests/L0/run_utils/test_profiler_summary.py`` cases on the CPU: a
traced step with an ``annotate`` range writes the gzipped Chrome trace
where ``summarize_trace`` globs (``<log_dir>/plugins/profile/<run>/``),
``device_only=False`` rows carry the five keys with positive totals and
name the range and the product, ``print_summary`` prints its table, the
newest run is the one read, and ``device_only=True`` on a host trace
raises the reference's ValueError (a CPU trace has no kernel, copy or
set events); no profile run and an empty run raise FileNotFoundError.
The trace layout and the rows' keys are the JAX package's; its device
lanes are ``/device`` processes, the port's the kernel categories
(``profiler.DEVICE_CATEGORIES``)."""

import glob
import io
import os

import pytest
import torch

from apex_tpu_torch.utils.profiler import (
    DEVICE_CATEGORIES, annotate, print_summary, summarize_trace, trace,
)


def _step(x):
    with annotate("matmul_region"):
        return x @ x


def test_trace_and_summarize(tmp_path):
    d = str(tmp_path / "tb")
    x = torch.ones(128, 128)
    _step(x)   # once outside the trace, as on the card
    with trace(d):
        _step(x)
    files = glob.glob(os.path.join(d, "plugins", "profile", "*",
                                   "*.trace.json.gz"))
    assert len(files) == 1
    rows = summarize_trace(d, top=50, device_only=False)
    assert rows and all(r["total_us"] > 0 for r in rows)
    assert all(set(r) >= {"name", "process", "count", "total_us",
                          "avg_us"} for r in rows)
    names = {r["name"] for r in rows}
    assert "matmul_region" in names and "aten::matmul" in names
    assert rows == sorted(rows, key=lambda r: -r["total_us"])

    buf = io.StringIO()
    print_summary(d, top=5, device_only=False, file=buf)
    out = buf.getvalue()
    assert "total_us" in out and len(out.splitlines()) >= 2
    assert len(out.splitlines()) <= 6


def test_newest_run_is_read(tmp_path):
    d = str(tmp_path / "tb")
    with trace(d):
        torch.ones(8).sum()
    with trace(d):
        with annotate("second_run"):
            torch.ones(8).sum()
    assert len(glob.glob(os.path.join(d, "plugins", "profile", "*"))) == 2
    names = {r["name"] for r in summarize_trace(d, device_only=False)}
    assert "second_run" in names


def test_device_only_on_host_trace_raises(tmp_path):
    d = str(tmp_path / "tb2")
    x = torch.ones(64, 64)
    with trace(d):
        x @ x
    with pytest.raises(ValueError, match="device_only=False"):
        summarize_trace(d)
    assert set(DEVICE_CATEGORIES) == {"kernel", "gpu_memcpy", "gpu_memset"}


def test_missing_runs_raise(tmp_path):
    with pytest.raises(FileNotFoundError, match="no profile runs"):
        summarize_trace(str(tmp_path / "none"))
    os.makedirs(tmp_path / "empty" / "plugins" / "profile" / "run0")
    with pytest.raises(FileNotFoundError, match="trace.json.gz"):
        summarize_trace(str(tmp_path / "empty"))

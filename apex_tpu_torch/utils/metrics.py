"""Training metrics (counterpart of ``apex_tpu/utils/metrics.py``): the
``AverageMeter`` the reference's ``examples/imagenet/main_amp.py`` rolls
by hand, and a samples-per-second meter."""

import time
from typing import Optional


class AverageMeter:
    def __init__(self, name: str = "", fmt: str = ":f"):
        self.name = name
        self.fmt = fmt
        self.reset()

    def reset(self):
        self.val = 0.0
        self.sum = 0.0
        self.count = 0
        self.avg = 0.0

    def update(self, val: float, n: int = 1):
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)

    def __str__(self):
        return ("{name} {val" + self.fmt + "} ({avg" + self.fmt + "})").format(
            name=self.name, val=self.val, avg=self.avg)


class Throughput:
    """Samples per second on the host's clock: call ``start()`` after the
    warm-up step (with the device synchronised), ``tick(n)`` per step."""

    def __init__(self):
        self._t0: Optional[float] = None
        self.samples = 0

    def start(self):
        self._t0 = time.perf_counter()
        self.samples = 0

    def tick(self, n: int):
        self.samples += n

    @property
    def per_sec(self) -> float:
        if self._t0 is None:
            return 0.0
        dt = time.perf_counter() - self._t0
        return self.samples / dt if dt > 0 else 0.0

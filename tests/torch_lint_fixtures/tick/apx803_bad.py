# apxlint: fixture
"""Known-bad APX803: an untyped device guard raised on the tick path
falls through every degrade ladder."""


class Sched:
    def step(self):
        if not self.engine.device_ok:
            raise RuntimeError("kernel needs CUDA tensors")

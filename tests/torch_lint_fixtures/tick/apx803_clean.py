# apxlint: fixture
"""Known-clean APX803 twin: a taxonomy class from the port's health
module on the tick path; the device guard stays in a constructor the
tick does not reach."""
from apex_tpu_torch.serving.health import NonFiniteLogits


class Sched:
    def __init__(self, engine):
        if not engine.device_ok:
            raise RuntimeError("kernel needs CUDA tensors")
        self.engine = engine

    def step(self):
        if not self.engine.finite:
            raise NonFiniteLogits(0, "decode")
        if self.engine.slots < 1:
            raise ValueError("num_slots must be >= 1")

# apxlint: fixture
"""Known-clean APX801 torch twin: every draw takes a seeded generator,
the requeue iterates sorted(...)."""
import torch


class Sched:
    def step(self, probs, gen):
        noise = torch.rand(probs.shape[0], generator=gen)
        probs.uniform_(generator=gen)
        tok = torch.multinomial(probs, 1, generator=gen)
        for i in sorted(set(self._preempted)):
            self._queue.appendleft(i)
        return tok, noise

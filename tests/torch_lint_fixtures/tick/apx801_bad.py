# apxlint: fixture
"""Known-bad APX801 in the torch idiom: torch draws from the process's
global stream on the tick path (a module function, an in-place method
and a tensor method, none with a generator), and an unsorted set
requeue."""
import torch


class Sched:
    def step(self, probs):
        noise = torch.rand(probs.shape[0])        # global stream
        probs.uniform_()                          # in place, global
        tok = probs.multinomial(1)                # tensor method, global
        for i in set(self._preempted):            # requeue order
            self._queue.appendleft(i)
        return tok, noise

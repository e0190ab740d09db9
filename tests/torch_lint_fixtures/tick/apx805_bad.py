# apxlint: fixture
"""Known-bad APX805 in the port's idiom: a raw PRNGKey consumed, the
same key consumed twice, and a prng split tree on the tick path."""
from apex_tpu_torch.utils import prng


class Engine:
    def step(self, seed, logits):
        key = prng.PRNGKey(seed)                 # consumed raw
        a = self.sample(logits, key)             # first consumer
        b = self.sample(logits, key)             # reuse: correlated
        k1, k2 = prng.split(key)                 # split tree
        return a, b, k1, k2

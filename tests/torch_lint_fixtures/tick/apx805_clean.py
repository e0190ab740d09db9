# apxlint: fixture
"""Known-clean APX805 twin: fold_in(PRNGKey(seed), counter) per slot,
batched by stack, and a named seed key folded at every offset (the
scheduler's _key_grid: deriving is not consuming)."""
import torch

from apex_tpu_torch.utils import prng


class Engine:
    def step(self, seeds, counter, logits):
        keys = torch.stack([prng.fold_in(prng.PRNGKey(s), counter)
                            for s in seeds])
        return self.sample(logits, keys)

    def _key_grid(self, seed, offs):
        base = prng.PRNGKey(seed)
        return torch.stack([prng.fold_in(base, int(o)) for o in offs])

# apxlint: fixture
# Known-bad APX402: a global write in a function activation
# checkpointing recomputes (it counts twice for one step).
import torch.utils.checkpoint

_CALLS = 0


def counted_block(x):
    global _CALLS
    _CALLS += 1
    return x * 2.0


def forward(x):
    return torch.utils.checkpoint.checkpoint(counted_block, x,
                                             use_reentrant=False)

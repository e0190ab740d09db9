# apxlint: fixture
# apxlint: disable-file=APX401, APX402
# The apx401/apx402 violations below, silenced file-wide with a single
# header comment. Must lint clean.
import time

from torch.utils.checkpoint import checkpoint

_CALLS = 0


def block(x):
    global _CALLS
    _CALLS += 1
    return x * time.time()


def forward(x):
    return checkpoint(block, x, use_reentrant=False)

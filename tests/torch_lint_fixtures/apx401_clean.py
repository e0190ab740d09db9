# apxlint: fixture
# Known-clean APX401/402 twin: captures, compiles and recomputes of
# tensor work only; host reads stay outside them, and eager code that is
# not a root (an autograd Function, a re.compile pattern) may read and
# count freely.
import re
import time

import torch
from torch.utils.checkpoint import checkpoint

_PATTERN = re.compile(r"\d+")
_CALLS = 0


def scale(buf, by):
    buf.mul_(by)


def capture(buf, by):
    t0 = time.perf_counter()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        scale(buf, by)
    return graph, time.perf_counter() - t0


@torch.compile
def compiled(x):
    return x * 2.0


def block(x):
    return torch.relu(x) * 2.0


def forward(x):
    return checkpoint(block, x, use_reentrant=False)


class _Counted(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        global _CALLS
        _CALLS += 1
        return x * time.time()

    @staticmethod
    def backward(ctx, g):
        return g

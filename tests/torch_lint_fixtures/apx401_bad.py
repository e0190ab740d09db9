# apxlint: fixture
# Known-bad APX401: host state read where Python runs a different
# number of times than the work — inside a CUDA-graph capture (a with
# block, a capture_begin/capture_end run, and a function the capture
# calls), under torch.compile, and in a function an activation
# checkpoint recomputes. Each read must raise APX401.
import random
import time

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from apex_tpu_torch.serving import FaultInjector

_INJECTOR = FaultInjector()


def stamp(buf):
    buf.fill_(time.time())                     # reached from the capture


def capture(buf):
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        stamp(buf)
        buf.add_(time.perf_counter())          # in the captured block
    return graph


def capture_by_hand(buf):
    graph = torch.cuda.CUDAGraph()
    graph.capture_begin()
    buf.mul_(random.random())                  # between begin and end
    graph.capture_end()
    return graph


@torch.compile
def compiled_decode(x):
    return x * _INJECTOR.calls("decode_exec")  # registered host state


def noisy_block(x):
    return x * float(np.random.rand())         # recomputed: a new draw


def forward(x):
    return checkpoint(noisy_block, x, use_reentrant=False)

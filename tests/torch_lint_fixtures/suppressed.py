# apxlint: fixture
# The APX401 read of apx401_bad, silenced both ways the engine supports:
# an inline trailing comment and a standalone comment line directly above
# the flagged statement. Must lint clean.
import time

import torch


def capture(buf):
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        buf.add_(time.time())  # apxlint: disable=APX401
        # apxlint: disable=APX401
        buf.mul_(time.time())
    return graph

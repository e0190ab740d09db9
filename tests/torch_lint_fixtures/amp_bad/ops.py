# apxlint: fixture
# Known-bad wiring in the port's idiom: 'bmm' is intercepted but listed
# nowhere (APX302); the 'linear' call makes lists.py's UNWIRED entry
# stale.
import torch
import torch.nn.functional as F

from apex_tpu_torch.amp.autocast import cast_args


def matmul(a, b):
    a, b = cast_args("matmul", a, b)
    return torch.matmul(a, b)


def linear(x, w):
    x, w = cast_args("linear", x, w)
    return F.linear(x, w)


def bmm(a, b):
    a, b = cast_args("bmm", a, b)
    return torch.bmm(a, b)

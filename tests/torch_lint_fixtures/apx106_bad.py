# apxlint: fixture
# Known-bad: the int8 quantization contract broken the torch way — a
# scale stored through fp16, a scale allocated in bf16, a dequant
# product on a bf16 operand, one on an operand of unknown dtype, and a
# truncating int8 cast with no round in scope. Each must raise APX106.
import torch


def _dequant(wq, scale):
    return wq.float() * scale[None, :]


class Int8Cache:
    def __init__(self, n, scale):
        self.k_scale = scale.half()                        # (a) store
        self.v_scale = torch.zeros(n, dtype=torch.bfloat16)  # (a) alloc


def w8_matmul(x, wq, scale):
    return torch.matmul(x.bfloat16(), _dequant(wq, scale))  # (b) bf16


def dequant_linear(x, wq, scale):
    return x @ _dequant(wq, scale).t()                     # (b) unknown


def quantize_truncating(w):
    scale = w.float().abs().amax(dim=0) / 127.0
    return (w.float() / scale).to(torch.int8), scale       # (c) no round

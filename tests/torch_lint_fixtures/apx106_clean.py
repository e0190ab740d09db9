# apxlint: fixture
# Known-clean APX106 twin: fp32 scales, dequant products on fp32
# operands (through .float(), a _dequant result, a name bound to one,
# .t() and .abs() views, an if-expression of fp32 arms), and
# round-to-nearest int8 casts (a randint draw is integer already).
import torch


def _dequant(wq, scale):
    return wq.float() * scale[None, :]


class Int8Cache:
    def __init__(self, n, scale):
        self.k_scale = scale.float()
        self.v_scale = torch.zeros(n, dtype=torch.float32)


def w8_matmul(x, wq, scale, nk=False):
    x2 = x.reshape(-1, x.shape[-1]).float()
    w = _dequant(wq, scale)
    w = w.t() if nk else w
    mag = torch.matmul(x2.abs(), w.abs())
    return torch.matmul(x2, w) + 2.0 * mag


def dequant_linear(x, wq, scale):
    return x.to(torch.float32) @ _dequant(wq, scale).t()


def quantize(w):
    scale = w.float().abs().amax(dim=0) / 127.0
    q = torch.round(w.float() / scale).clamp(-127, 127)
    return q.to(torch.int8), scale


def random_codes(shape):
    return torch.randint(-127, 128, shape).to(torch.int8)

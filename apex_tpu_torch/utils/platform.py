"""Device resolution for the port's entry points.

The JAX package resolves ``interpret=None`` to "run Pallas in interpret
mode off the TPU". The port has no interpret mode: a CUDA kernel runs
only on the card. Instead, entry points take a ``device`` and run on the
card unless the caller asks for the CPU, where each kernel wrapper uses
its plain PyTorch version. There is no silent fallback: asking for the
card on a host without one raises.
"""

from typing import Union

import torch

DeviceLike = Union[None, str, torch.device]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means the card (``cuda``). A CUDA device on a host
    without CUDA raises a ``RuntimeError`` naming the way out."""
    dev = torch.device("cuda") if device is None else torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "apex_tpu_torch runs on the CUDA device by default, but "
            "torch.cuda.is_available() is False on this host; pass "
            "device='cpu' to run the plain PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise RuntimeError(
            f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


def on_card(t: torch.Tensor, what: str = "tensor") -> bool:
    """Dispatch rule shared by every kernel wrapper: True for a CUDA
    tensor (launch the kernel), False for a CPU tensor (plain version);
    any other device raises."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise RuntimeError(f"{what} lies on {t.device}; the port runs on "
                       "'cuda' (kernels) or 'cpu' (plain versions)")


# apxlint: fixture
# Known-clean wiring for amp_clean/lists.py.
import torch

from apex_tpu_torch.amp.autocast import cast_args


def matmul(a, b):
    a, b = cast_args("matmul", a, b)
    return torch.matmul(a, b)

"""Optional accelerants: :mod:`xentropy`, the fused softmax cross
entropy."""

from apex_tpu_torch.contrib import xentropy  # noqa: F401

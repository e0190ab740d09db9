"""The MLP block (counterpart of ``apex_tpu/mlp``)."""

from apex_tpu_torch.mlp.mlp import MLP  # noqa: F401

"""Transformer building blocks (counterpart of
``apex_tpu/transformer/__init__.py``): the functional attention, the
enums, ``parallel_state``, ``tensor_parallel``, ``pipeline_parallel``,
``layers`` and the logging helpers."""

from apex_tpu_torch.transformer import functional  # noqa: F401
from apex_tpu_torch.transformer import layers  # noqa: F401
from apex_tpu_torch.transformer import parallel_state  # noqa: F401
from apex_tpu_torch.transformer import pipeline_parallel  # noqa: F401
from apex_tpu_torch.transformer import tensor_parallel  # noqa: F401
from apex_tpu_torch.transformer.enums import (  # noqa: F401
    AttnMaskType,
    AttnType,
    LayerType,
    ModelType,
)
from apex_tpu_torch.transformer.log_util import (  # noqa: F401
    get_transformer_logger,
    set_logging_level,
)

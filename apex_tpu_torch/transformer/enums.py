"""Transformer enums (counterpart of ``apex_tpu/transformer/enums.py``;
the port keeps its own copy of the one it uses)."""

import enum


class AttnMaskType(enum.Enum):
    padding = 1
    causal = 2

"""Logging helpers (counterpart of ``apex_tpu/transformer/log_util.py``;
reference: ``apex/transformer/log_util.py :: set_logging_level``)."""

import logging

_LOGGER_NAME = "apex_tpu_torch"


def get_transformer_logger(name: str = _LOGGER_NAME) -> logging.Logger:
    return logging.getLogger(name)


def set_logging_level(verbosity) -> None:
    """Set the apex_tpu_torch logger level (int or logging level
    name)."""
    if isinstance(verbosity, str):
        verbosity = getattr(logging, verbosity.upper())
    logging.getLogger(_LOGGER_NAME).setLevel(verbosity)

"""The process-global args registry (counterpart of
``apex_tpu/transformer/testing/global_vars.py``; reference:
``apex/transformer/testing/global_vars.py :: get_args``): Megatron keeps
the parsed flags in a module global that schedules and test helpers
read. Each rank's process holds its own."""

_GLOBAL_ARGS = None


def set_args(args) -> None:
    global _GLOBAL_ARGS
    _GLOBAL_ARGS = args


def get_args():
    if _GLOBAL_ARGS is None:
        raise RuntimeError(
            "global args not initialized — call set_args(parse_args()) "
            "first (ref: Megatron's set_global_variables)")
    return _GLOBAL_ARGS


def unset_args() -> None:
    """Test teardown helper."""
    global _GLOBAL_ARGS
    _GLOBAL_ARGS = None


def args_are_set() -> bool:
    return _GLOBAL_ARGS is not None

"""Small integer-math helpers (counterpart of ``apex_tpu/utils/math.py``)."""


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up_to_multiple(x: int, m: int) -> int:
    return cdiv(x, m) * m

"""``jax.random``'s threefry streams in torch, bit for bit.

The JAX package draws every random number through ``jax.random``; this
module is the port's counterpart and has none in the JAX package. It
reproduces the installed jax (0.9.0) with
``jax_threefry_partitionable=True``, the installed default, under
``jax.random``'s names, so a call maps one to one:

- :func:`PRNGKey`, :func:`split`, :func:`fold_in`: keys are int64 tensors
  of shape ``(2,)`` holding the two uint32 words, kept on the host.
  Deriving one is a threefry of two words; the flash kernels take their
  dropout seed as launch arguments and the scheduler derives a key a
  slot a tick, so no step waits on the device for a key.
- :func:`bits`, :func:`uniform`, :func:`bernoulli`, :func:`gumbel`,
  :func:`categorical`, :func:`normal`, :func:`randint` draw on
  ``device`` (``None``: the card). Bits and uniforms equal jax's bit for
  bit, and so do ``bernoulli`` and ``randint``. ``gumbel`` and
  ``normal`` go through ``log`` and ``erfinv``, which no two libraries
  round alike: :func:`gumbel_limit` and :func:`normal_limit` state how
  far from jax's they may land, and ``categorical`` takes the same
  token except where a row's two best perturbed scores lie inside twice
  the gumbel limit.
- :func:`dropout`, the port's fused form of ``x * bernoulli(key, 1 -
  rate, x.shape) / (1 - rate)`` as XLA compiles it, and
  :func:`categorical_rows`, ``jax.vmap(categorical)`` over one key a row.

The hash (``jax/_src/prng.py``: ``threefry_2x32`` :1092, its rounds in
``_threefry2x32_lowering`` :883) runs on int64 tensors holding uint32
values, masked to 32 bits after every add. The bulk bits — the only part
that scales with the data — come from ``csrc/threefry.cu`` on a CUDA
device (:data:`THREEFRY_BITS`, :data:`THREEFRY_DROPOUT`) and from the
plain int64 version on the CPU; a CUDA tensor never reaches the plain
version except by name. Floating draws are fp32 only (jax's default
dtype; its 8-bit path for bf16 and fp16 is not ported).
"""

import ctypes
import math
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from apex_tpu_torch.utils.cuda_build import CudaLibrary, Kernel
from apex_tpu_torch.utils.platform import DeviceLike, on_card, resolve_device

M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_TINY = float(np.finfo(np.float32).tiny)
# jax.random.normal's lower bound: the float32 after -1 towards 0
_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
_U = 2.0 ** -24   # fp32 unit roundoff

LIB = CudaLibrary("threefry")
_P = ctypes.c_void_p
THREEFRY_BITS = Kernel(LIB, "apx_threefry_bits",
                       [_P, ctypes.c_uint, ctypes.c_uint, _P,
                        ctypes.c_longlong, ctypes.c_int, _P])
THREEFRY_DROPOUT = Kernel(LIB, "apx_threefry_dropout",
                          [_P, _P, ctypes.c_longlong, ctypes.c_int,
                           ctypes.c_uint, ctypes.c_uint, ctypes.c_float,
                           ctypes.c_float, _P])
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

Shape = Union[int, Sequence[int]]


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32, 20 rounds, on uint32 values held in Python ints or
    int64 tensors (broadcast against each other); returns the two output
    words. ``jax.random``'s ``threefry2x32_p``."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + k0) & M32
    x1 = (x1 + k1) & M32
    for s in range(5):
        for r in _ROTATIONS[s % 2]:
            x0 = (x0 + x1) & M32
            x1 = ((x1 << r) & M32) | (x1 >> (32 - r))
            x1 = x1 ^ x0
        x0 = (x0 + ks[(s + 1) % 3]) & M32
        x1 = (x1 + ks[(s + 2) % 3] + s + 1) & M32
    return x0, x1


def _shape(shape: Shape) -> Tuple[int, ...]:
    return (int(shape),) if isinstance(shape, int) else tuple(
        int(d) for d in shape)


def _key_words(key) -> Tuple[int, int]:
    """The two uint32 words of a key; anything but two words in [0,
    2^32) raises."""
    if not isinstance(key, (torch.Tensor, np.ndarray, list, tuple)):
        raise TypeError(f"a PRNG key is a (2,) tensor of uint32 words, got "
                        f"{type(key).__name__}")
    t = torch.as_tensor(key)
    if t.shape != (2,) or t.is_floating_point() or t.is_complex():
        raise ValueError(f"a PRNG key is two uint32 words of shape (2,), "
                         f"got shape {tuple(t.shape)} {t.dtype}")
    k0, k1 = (int(w) for w in t.tolist())
    if not (0 <= k0 <= M32 and 0 <= k1 <= M32):
        raise ValueError(f"PRNG key words must lie in [0, 2^32), got "
                         f"({k0}, {k1})")
    return k0, k1


def _host_rows(keys) -> torch.Tensor:
    """(R, 2) int64 host tensor of key words, checked."""
    t = torch.as_tensor(keys).to("cpu", torch.int64).reshape(-1, 2)
    if bool(((t < 0) | (t > M32)).any()):
        raise ValueError("PRNG key words must lie in [0, 2^32)")
    return t


def _on_device(keys) -> bool:
    """Keys given as an int32 (R, 2) buffer of words on a CUDA device
    (what a CUDA graph replays), not as host keys."""
    return isinstance(keys, torch.Tensor) and keys.device.type == "cuda"


def _key(k0: int, k1: int) -> torch.Tensor:
    return torch.tensor([k0, k1], dtype=torch.int64)


def PRNGKey(seed: int) -> torch.Tensor:
    """``jax.random.PRNGKey``: with jax's default 32-bit integers a seed
    keeps its low 32 bits, so ``PRNGKey(-1)`` is ``(0, 0xffffffff)`` and
    ``PRNGKey(2**32 + 5)`` is ``(0, 5)`` (``_threefry_seed``)."""
    return _key(0, int(seed) & M32)


def split(key, num: Shape = 2) -> torch.Tensor:
    """``jax.random.split`` (``_threefry_split_foldlike``): key ``j`` of
    the flat shape is the hash of the counter pair (j >> 32, j & M32).
    Returns ``(*shape, 2)``."""
    k0, k1 = _key_words(key)
    shape = _shape(num)
    j = torch.arange(math.prod(shape), dtype=torch.int64)
    a, b = threefry2x32(k0, k1, j >> 32, j & M32)
    return torch.stack([a, b], dim=-1).reshape(*shape, 2)


def fold_in(key, data: int) -> torch.Tensor:
    """``jax.random.fold_in`` (``_threefry_fold_in``): the hash of the
    counter pair (0, data) with ``data`` as uint32."""
    k0, k1 = _key_words(key)
    return _key(*threefry2x32(k0, k1, 0, int(data) & M32))


def host_bits(key, n: int) -> Tuple[int, ...]:
    """``bits(key, (n,))`` as Python ints computed on the host, for the
    few words a kernel takes as launch arguments (the flash-attention
    dropout seed): no tensor op, no device."""
    k0, k1 = _key_words(key)
    return tuple(a ^ b for a, b in (threefry2x32(k0, k1, j >> 32, j & M32)
                                    for j in range(n)))


# -- the bulk bits: kernel and plain version --------------------------------

def _to_int32(words: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 with the same bits."""
    return (words - ((words >> 31) << 32)).to(torch.int32)


def threefry_bits_plain(keys, n: int, device: DeviceLike) -> torch.Tensor:
    """(R, n) int32 words of R rows of n elements, row r under key
    ``keys[r]``, element j the hash of (j >> 32, j & M32) with its two
    words xored: jax's partitionable 32-bit bits. The int64 arithmetic
    of :func:`threefry2x32` on ``device``; ``keys`` are (R, 2) host keys
    (one key enters as two scalars) or an int32 word buffer on the
    device."""
    j = torch.arange(n, dtype=torch.int64, device=device)[None]
    if _on_device(keys):
        rows = keys.reshape(-1, 2).to(torch.int64) & M32
        k0, k1 = rows[:, :1], rows[:, 1:]
    else:
        rows = _host_rows(keys)
        if rows.shape[0] == 1:
            k0, k1 = (int(w) for w in rows[0].tolist())
        else:
            rows = rows.to(device)
            k0, k1 = rows[:, :1], rows[:, 1:]
    a, b = threefry2x32(k0, k1, j >> 32, j & M32)
    return _to_int32(a ^ b)


def threefry_bits_kernel(keys, n: int, device: DeviceLike) -> torch.Tensor:
    """:func:`threefry_bits_plain` by ``csrc/threefry.cu`` on a CUDA
    ``device``: one host key is passed by value, several as an (R, 2)
    uint32 buffer copied to the device; a device buffer is read as it
    is."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise RuntimeError(f"threefry bits kernel needs a CUDA device, got "
                           f"{dev}")
    if _on_device(keys):
        if keys.dtype != torch.int32 or not keys.is_contiguous() \
                or keys.shape[-1] != 2 or keys.device != dev:
            raise RuntimeError(f"threefry bits kernel needs contiguous "
                               f"int32 (R, 2) keys on {dev}, got "
                               f"{tuple(keys.shape)} {keys.dtype} on "
                               f"{keys.device}")
        buf, r, k0, k1 = keys, keys.numel() // 2, 0, 0
    else:
        rows = _host_rows(keys)
        r = rows.shape[0]
        k0, k1 = (int(w) for w in rows[0].tolist())
        buf = None if r == 1 else _to_int32(rows).to(dev)
    if not 1 <= r <= 65535:
        raise RuntimeError(f"threefry bits kernel takes 1 to 65535 keys, "
                           f"got {r}")
    out = torch.empty((r, n), dtype=torch.int32, device=dev)
    THREEFRY_BITS(None if buf is None else buf.data_ptr(), k0, k1,
                  out.data_ptr(), n, r,
                  torch.cuda.current_stream(dev).cuda_stream)
    return out


def _bits_rows(keys, n: int, device: torch.device) -> torch.Tensor:
    """Dispatch: the kernel on a CUDA device, the plain version on the
    CPU."""
    if device.type == "cuda":
        return threefry_bits_kernel(keys, n, device)
    if device.type != "cpu":
        raise RuntimeError(f"threefry bits on {device}; the port runs on "
                           "'cuda' (kernels) or 'cpu' (plain versions)")
    return threefry_bits_plain(keys, n, device)


def _uniform01(words: torch.Tensor) -> torch.Tensor:
    """int32 words -> fp32 in [0, 1): the mantissa bits ``w >> 9`` under
    exponent 0, minus 1 (``jax.random._uniform``)."""
    return (((words >> 9) & 0x7FFFFF) | 0x3F800000).view(
        torch.float32) - 1.0


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def _scaled(u: torch.Tensor, minval: float, maxval: float) -> torch.Tensor:
    """``max(minval, u * (maxval - minval) + minval)`` in fp32, the tail
    of ``jax.random._uniform``, with the product and sum rounded once as
    XLA's fused multiply-add rounds them (the product of two fp32 values
    is exact in float64, and so is its sum with ``minval`` at the ranges
    drawn here)."""
    lo, hi = _f32(minval).to(u.device), _f32(maxval).to(u.device)
    fma = u.double() * (hi - lo).double() + lo.double()
    return torch.maximum(lo, fma.float())


def _check_float(dtype: torch.dtype, what: str) -> None:
    if dtype != torch.float32:
        raise ValueError(f"{what}: the port draws fp32 only (jax's default "
                         f"dtype), got {dtype}")


# -- jax.random's samplers ---------------------------------------------------

def bits(key, shape: Shape = (), dtype=None, *,
         device: DeviceLike = None) -> torch.Tensor:
    """``jax.random.bits`` with 32-bit words: int64 values in [0, 2^32)
    (the uint32 words jax returns), drawn on ``device``."""
    if dtype not in (None, torch.uint32):
        raise ValueError(f"bits: 32-bit words only, got {dtype}")
    shape = _shape(shape)
    w = _bits_rows(_key(*_key_words(key)), math.prod(shape),
                   resolve_device(device))
    return (w.to(torch.int64) & M32).reshape(shape)


def uniform(key, shape: Shape = (), dtype: torch.dtype = torch.float32,
            minval: float = 0.0, maxval: float = 1.0, *,
            device: DeviceLike = None) -> torch.Tensor:
    """``jax.random.uniform``: ``u * (maxval - minval) + minval`` and then
    at least ``minval``, every step in fp32, u from the word's mantissa
    bits."""
    _check_float(dtype, "uniform")
    shape = _shape(shape)
    words = _bits_rows(_key(*_key_words(key)), math.prod(shape),
                       resolve_device(device))
    return _scaled(_uniform01(words).reshape(shape), minval, maxval)


def bernoulli(key, p=0.5, shape: Optional[Shape] = None, *,
              device: DeviceLike = None) -> torch.Tensor:
    """``jax.random.bernoulli`` (mode "low"): ``uniform < p`` in fp32;
    ``shape`` defaults to ``p``'s. A tensor ``p`` fixes the device."""
    if isinstance(p, torch.Tensor):
        _check_float(p.dtype, "bernoulli")
        dev = p.device
    else:
        dev = resolve_device(device)
        p = _f32(p).to(dev)
    shape = tuple(p.shape) if shape is None else _shape(shape)
    return uniform(key, shape, device=dev) < p


def gumbel(key, shape: Shape = (), dtype: torch.dtype = torch.float32,
           mode: Optional[str] = None, *,
           device: DeviceLike = None) -> torch.Tensor:
    """``jax.random.gumbel`` in mode "low", jax's default:
    ``-log(-log(uniform(key, shape, minval=tiny)))``. Within
    :func:`gumbel_limit` of jax's values (torch's ``log`` rounds
    otherwise than XLA's)."""
    if mode not in (None, "low"):
        raise ValueError(f"gumbel: mode 'low' only, got {mode!r}")
    _check_float(dtype, "gumbel")
    shape = _shape(shape)
    return gumbel_rows(_key(*_key_words(key)), math.prod(shape),
                       resolve_device(device)).reshape(shape)


def gumbel_limit(g: torch.Tensor) -> torch.Tensor:
    """How far (per element) a gumbel value of this module may land from
    jax's on the same key: each ``log`` is within an ulp or two of the
    exact one, so t = -log(u) is within a few ulps relatively and
    -log(t) within that absolutely, plus a few ulps of |g|:
    ``2^-21 (1 + |g|)``."""
    return 8 * _U * (1.0 + g.abs())


def categorical(key, logits: torch.Tensor, axis: int = -1,
                shape: Optional[Shape] = None, replace: bool = True,
                mode: Optional[str] = None) -> torch.Tensor:
    """``jax.random.categorical`` with replacement: the argmax over
    ``axis`` of gumbel noise plus ``logits`` (the first maximum on ties,
    as ``jnp.argmax``), drawn on the logits' device. Returns int64
    indices."""
    if not replace:
        raise ValueError("categorical: sampling without replacement is not "
                         "ported")
    _check_float(logits.dtype, "categorical")
    axis = axis % logits.dim()
    batch = tuple(d for i, d in enumerate(logits.shape) if i != axis)
    shape = batch if shape is None else _shape(shape)
    prefix = shape[:len(shape) - len(batch)]
    full = list(shape[len(shape) - len(batch):])
    full.insert(axis, logits.shape[axis])
    g = gumbel(key, (*prefix, *full), mode=mode, device=logits.device)
    return torch.argmax(g + logits, dim=len(prefix) + axis)


def gumbel_rows(keys, n: int, device: DeviceLike) -> torch.Tensor:
    """(R, n) gumbel noise, row r drawn on ``keys[r]``:
    ``jax.vmap(lambda k: jax.random.gumbel(k, (n,)))(keys)``, from one
    bits launch on a CUDA device."""
    words = _bits_rows(keys, n, torch.device(device))
    return -torch.log(-torch.log(_scaled(_uniform01(words), _TINY, 1.0)))


def categorical_rows(keys, logits: torch.Tensor) -> torch.Tensor:
    """``jax.vmap(jax.random.categorical)(keys, logits)`` for (R, V)
    fp32 logits and (R, 2) keys: one key a row. Returns (R,) int64."""
    _check_float(logits.dtype, "categorical_rows")
    g = gumbel_rows(keys, logits.shape[-1], logits.device)
    return torch.argmax(g + logits, dim=-1)


def normal(key, shape: Shape = (), dtype: torch.dtype = torch.float32, *,
           device: DeviceLike = None) -> torch.Tensor:
    """``jax.random.normal`` (``_normal_real``): ``sqrt(2) *
    erfinv(uniform(key, shape, minval=nextafter(-1, 0), maxval=1))``.
    The uniforms are jax's bit for bit; ``erfinv`` is within
    :func:`normal_limit` of XLA's."""
    _check_float(dtype, "normal")
    u = uniform(key, shape, dtype, _NORMAL_LO, 1.0, device=device)
    return _f32(math.sqrt(2)).to(u.device) * torch.erfinv(u)


def normal_limit(z: torch.Tensor) -> torch.Tensor:
    """How far (per element) a normal value of this module may land from
    jax's on the same key: the uniforms are equal, and torch's
    ``erfinv`` sits within a few ulps of the exact value, but XLA's
    ``erf_inv`` polynomial is less accurate in its tail branch (|z| past
    about 2.8: 91 ulps, 5.8e-6 relatively, at z = -3.76 in 2M draws on
    the CPU), so the limit grows with |z|^3: ``2^-20 (1 + |z|^3)``."""
    return 16 * _U * (1.0 + z.abs() ** 3)


def randint(key, shape: Shape, minval: int, maxval: int,
            dtype: torch.dtype = torch.int32, *,
            device: DeviceLike = None) -> torch.Tensor:
    """``jax.random.randint`` for int32 (jax's default integer): two
    32-bit draws on ``split(key)``'s keys, ``(hi % span) * (2^32 %
    span) + lo % span`` modulo span in uint32 arithmetic, plus
    ``minval``; ``maxval <= minval`` gives ``minval``. Exact."""
    if dtype != torch.int32:
        raise ValueError(f"randint: int32 only (jax's default), got {dtype}")
    shape = _shape(shape)
    dev = resolve_device(device)
    minval, maxval = int(minval), int(maxval)
    if not all(-2 ** 31 <= v < 2 ** 31 for v in (minval, maxval)):
        raise OverflowError(f"randint: minval {minval} or maxval {maxval} "
                            "outside int32, which jax refuses too")
    span = 1 if maxval <= minval else maxval - minval
    mult = ((2 ** 16 % span) ** 2 & M32) % span   # uint32: wraps
    k_hi, k_lo = split(key)
    n = math.prod(shape)
    higher = _bits_rows(k_hi, n, dev).to(torch.int64) & M32
    lower = _bits_rows(k_lo, n, dev).to(torch.int64) & M32
    off = ((_mul32(higher % span, mult) + lower % span) & M32) % span
    return (minval + off).to(torch.int32).reshape(shape)


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 ``x`` and ``c`` in [0, 2^32): ``c`` in
    16-bit halves, so no int64 product overflows."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & M32


# -- fused dropout: kernel and plain version ---------------------------------

def dropout_constants(rate: float, dtype: torch.dtype) -> Tuple[float, float]:
    """(p, s): keep where the uniform is below p = fp32(1 - rate), and
    scale kept values by s = fp32(1 / c), c = ``1 - rate`` rounded to x's
    dtype (a weak-typed Python float takes x's dtype: bf16(0.9) is
    0.8984375). XLA compiles ``x * keep / c`` to ``x * keep * s``."""
    keep = 1.0 - float(rate)
    c = torch.tensor(keep, dtype=torch.float64).to(dtype).float()
    return float(_f32(keep)), float(_f32(1.0) / c)


def dropout_plain(x: torch.Tensor, key_words: Tuple[int, int],
                  rate: float) -> torch.Tensor:
    """``dtype(fp32(x) * keep * s)`` with the mask from
    :func:`threefry_bits_plain` over x's flat shape, on x's device."""
    p, s = dropout_constants(rate, x.dtype)
    u = _uniform01(threefry_bits_plain(_key(*key_words), x.numel(),
                                       x.device)).reshape(x.shape)
    keep = (u < p).float()
    return (x.float() * keep * s).to(x.dtype)


def dropout_kernel(x: torch.Tensor, key_words: Tuple[int, int],
                   rate: float) -> torch.Tensor:
    """:func:`dropout_plain` by ``csrc/threefry.cu``: one pass over x,
    the mask computed in registers and never stored."""
    if x.device.type != "cuda":
        raise RuntimeError(f"threefry dropout kernel needs CUDA tensors, got "
                           f"x on {x.device}")
    if x.dtype not in _DTYPE_CODE or not x.is_contiguous():
        raise RuntimeError(f"threefry dropout kernel needs a contiguous "
                           f"fp32/bf16 x, got {tuple(x.shape)} {x.dtype}")
    p, s = dropout_constants(rate, x.dtype)
    out = torch.empty_like(x)
    THREEFRY_DROPOUT(x.data_ptr(), out.data_ptr(), x.numel(),
                     _DTYPE_CODE[x.dtype], key_words[0], key_words[1], p, s,
                     torch.cuda.current_stream(x.device).cuda_stream)
    return out


def _dropout_any(x, key_words, rate):
    fn = dropout_kernel if on_card(x, "x") else dropout_plain
    return fn(x, key_words, rate)


class _Dropout(torch.autograd.Function):
    """The backward regenerates the mask from the key: it is the same
    function on the incoming gradient (XLA's VJP of ``x * keep / c`` is
    ``g * s`` where kept, 0 elsewhere), so no mask is saved."""

    @staticmethod
    def forward(ctx, x, key_words, rate):
        ctx.cfg = (key_words, rate)
        return _dropout_any(x.contiguous(), key_words, rate)

    @staticmethod
    def backward(ctx, g):
        key_words, rate = ctx.cfg
        return _dropout_any(g.contiguous(), key_words, rate), None, None


def dropout(key, x: torch.Tensor, rate: float) -> torch.Tensor:
    """``x * jax.random.bernoulli(key, 1 - rate, x.shape) / (1 - rate)``
    as the JAX package writes its dropout, in one pass (fp32 and bf16
    x); ``rate <= 0`` returns ``x``."""
    if rate <= 0.0:
        return x
    return _Dropout.apply(x, _key_words(key), float(rate))

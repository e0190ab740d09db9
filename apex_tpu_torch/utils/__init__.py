"""Small shared helpers: device resolution, integer math, bucketing,
jax.random's threefry streams (``prng``),
and the nvcc/ctypes build of the CUDA sources."""

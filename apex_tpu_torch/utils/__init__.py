"""Small shared helpers: device resolution, integer math, bucketing,
jax.random's threefry streams (``prng``), the nvcc/ctypes build of the
CUDA sources, checkpoints (``checkpoint``) and the profiler's trace
report (``profiler``)."""

"""Small shared helpers: device resolution, integer math, bucketing,
and the nvcc/ctypes build of the CUDA sources."""

"""Hand-written CUDA kernels and their wrappers (sources under csrc/)."""

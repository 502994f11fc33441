"""Hand-written CUDA kernels and their wrappers (sources in ../../csrc)."""

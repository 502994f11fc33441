"""Correlation and warping ops; CUDA kernels under ``ops.cuda``."""

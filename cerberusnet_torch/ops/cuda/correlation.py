"""Wrappers for the hand-written CUDA correlation kernels (csrc/correlation.cu).

``corr2d_fwd`` replaces the TPU kernel ``_corr2d_fwd_kernel`` and
``corr1d_fwd`` replaces ``_corr1d_fwd_kernel``, both in
``cerberusnet_tpu/ops/pallas/correlation.py``; the source note in
``csrc/correlation.cu`` gives each kernel's bound on an H100 and what its
design does about it. Their plain PyTorch versions are
``_correlation2d_plain`` and ``_correlation1d_plain`` in
``cerberusnet_torch/ops/correlation.py``.

A wrapper takes NHWC-contiguous float32 or bfloat16 CUDA tensors of equal
shape, allocates the output with ``torch.empty``, launches on the current
stream without synchronising, and raises on anything the kernel does not
take or on a refused launch. ``corr2d_fwd_launches`` and
``corr1d_fwd_launches`` count the launches; nothing else changes them.
"""

from __future__ import annotations

import ctypes

import torch

from cerberusnet_torch.ops import build

corr2d_fwd_launches = 0
corr1d_fwd_launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p]


def _library() -> ctypes.CDLL:
    lib = build.load("correlation")
    if lib.corr2d_fwd.argtypes is None:
        for fn in (lib.corr2d_fwd, lib.corr1d_fwd):
            fn.argtypes = _ARGTYPES
            fn.restype = ctypes.c_int
        lib.corr_error_string.argtypes = [ctypes.c_int]
        lib.corr_error_string.restype = ctypes.c_char_p
    return lib


def _check(f1: torch.Tensor, f2: torch.Tensor, max_disp: int, dilation: int):
    if f1.device.type != "cuda" or f2.device != f1.device:
        raise ValueError(
            f"CUDA correlation needs both tensors on one CUDA device, got "
            f"{f1.device} and {f2.device}")
    if f1.dtype not in _DTYPES or f2.dtype != f1.dtype:
        raise ValueError(
            f"CUDA correlation takes float32 or bfloat16, got {f1.dtype} and "
            f"{f2.dtype}")
    if f1.dim() != 4 or f1.shape != f2.shape:
        raise ValueError(
            f"CUDA correlation needs two (B,H,W,C) tensors of one shape, got "
            f"{tuple(f1.shape)} and {tuple(f2.shape)}")
    if not (f1.is_contiguous() and f2.is_contiguous()):
        raise ValueError("CUDA correlation needs NHWC-contiguous tensors")
    if max_disp < 0 or dilation < 1:
        raise ValueError(f"bad max_disp={max_disp} / dilation={dilation}")


def _launch(fn_name: str, f1, f2, max_disp: int, dilation: int, nk: int):
    _check(f1, f2, max_disp, dilation)
    b, h, w, c = f1.shape
    out = torch.empty((b, h, w, nk), dtype=f1.dtype, device=f1.device)
    lib = _library()
    with torch.cuda.device(f1.device):
        stream = torch.cuda.current_stream(f1.device).cuda_stream
        err = getattr(lib, fn_name)(
            f1.data_ptr(), f2.data_ptr(), out.data_ptr(), b, h, w, c,
            max_disp, dilation, _DTYPES[f1.dtype], stream)
    if err != 0:
        raise RuntimeError(
            f"{fn_name} launch failed: {lib.corr_error_string(err).decode()} "
            f"(shape {tuple(f1.shape)}, max_disp {max_disp}, dilation "
            f"{dilation}, {f1.dtype})")
    return out


def corr2d_fwd(f1: torch.Tensor, f2: torch.Tensor, max_disp: int,
               dilation: int = 1) -> torch.Tensor:
    """(B,H,W,C) x2 -> (B,H,W,(2*max_disp+1)**2) on the CUDA kernel."""
    global corr2d_fwd_launches
    out = _launch("corr2d_fwd", f1, f2, max_disp, dilation,
                  (2 * max_disp + 1) ** 2)
    corr2d_fwd_launches += 1
    return out


def corr1d_fwd(f1: torch.Tensor, f2: torch.Tensor, max_disp: int,
               dilation: int = 1) -> torch.Tensor:
    """(B,H,W,C) x2 -> (B,H,W,max_disp+1) on the CUDA kernel."""
    global corr1d_fwd_launches
    out = _launch("corr1d_fwd", f1, f2, max_disp, dilation, max_disp + 1)
    corr1d_fwd_launches += 1
    return out

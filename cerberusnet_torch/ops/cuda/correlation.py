"""Wrappers for the hand-written CUDA correlation kernels (csrc/correlation.cu).

Each wrapper replaces one TPU kernel of
``cerberusnet_tpu/ops/pallas/correlation.py``:

  corr2d_fwd     _corr2d_fwd_kernel       2-D cost volume
  corr2d_bwd_f1  _corr2d_bwd_f1_kernel    its gradient for f1
  corr2d_bwd_f2  _corr2d_bwd_f2_kernel    its gradient for f2
  corr1d_fwd     _corr1d_fwd_kernel       1-D cost volume
  corr1d_bwd_f1  _corr1d_bwd_f1_kernel    its gradient for f1
  corr1d_bwd_f2  _corr1d_bwd_f2_kernel    its gradient for f2

At dilation > 1 (the DCV heads) corr2d_fwd and corr1d_fwd also replace
``_corr2d_wl_kernel`` and ``_corr1d_wl_kernel``, the dilated W-in-lanes
forms of the same two cost volumes.

The source note in ``csrc/correlation.cu`` gives each kernel's bound on an
H100 and what its design does about it. Their plain PyTorch versions are
the ``_correlation{2d,1d}[_bwd_f1,_bwd_f2]_plain`` functions in
``cerberusnet_torch/ops/correlation.py``.

A wrapper takes NHWC-contiguous float32 or bfloat16 CUDA tensors of one
type (two features for a forward; the cost volume's gradient and one
feature for a backward), allocates the output with ``torch.empty``,
launches on the current stream without synchronising, and raises on
anything the kernel does not take or on a refused launch. Each kernel has
its launch counter, ``<name>_launches``; nothing else changes them. The
library also counts its launches by design (``launched_design``): in
bfloat16 every kernel runs on the tensor cores, in float32 on the CUDA
cores.
"""

from __future__ import annotations

import ctypes

import torch

from cerberusnet_torch.ops import build

corr2d_fwd_launches = 0
corr1d_fwd_launches = 0
corr2d_bwd_f1_launches = 0
corr2d_bwd_f2_launches = 0
corr1d_bwd_f1_launches = 0
corr1d_bwd_f2_launches = 0

KERNELS = ("corr2d_fwd", "corr1d_fwd", "corr2d_bwd_f1", "corr2d_bwd_f2",
           "corr1d_bwd_f1", "corr1d_bwd_f2")
# the rows of the library's corr_design_launches
DESIGNS = ("tc", "cuda_cores")

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p]


def launches() -> dict:
    """{kernel name: launches so far}."""
    return {name: globals()[f"{name}_launches"] for name in KERNELS}


def reset_launches():
    for name in KERNELS:
        globals()[f"{name}_launches"] = 0


def _library() -> ctypes.CDLL:
    lib = build.load("correlation")
    if lib.corr2d_fwd.argtypes is None:
        for name in KERNELS:
            fn = getattr(lib, name)
            fn.argtypes = _ARGTYPES
            fn.restype = ctypes.c_int
        lib.corr_error_string.argtypes = [ctypes.c_int]
        lib.corr_error_string.restype = ctypes.c_char_p
    return lib


def _design_launches() -> ctypes.Array:
    return (ctypes.c_ulonglong * len(DESIGNS)).in_dll(
        _library(), "corr_design_launches")


def reset_design_launches():
    """Zeroes the library's launches by design."""
    counts = _design_launches()
    for i in range(len(counts)):
        counts[i] = 0


def launched_design() -> str:
    """The design whose kernels the library launched since
    reset_design_launches(): "tc" (the tensor-core kernels), "cuda_cores",
    both joined by "+", or "none". The library counts where each launch
    succeeds (csrc/correlation.cu ``corr_design_launches``)."""
    ran = [d for d, n in zip(DESIGNS, _design_launches()) if n]
    return "+".join(ran) or "none"


def _check(a: torch.Tensor, f: torch.Tensor, nk: int, max_disp: int,
           dilation: int):
    """``f`` is a (B,H,W,C) feature map; ``a`` the other feature map
    (nk == C) or the cost volume's gradient (nk channels)."""
    if f.device.type != "cuda" or a.device != f.device:
        raise ValueError(
            f"CUDA correlation needs both tensors on one CUDA device, got "
            f"{a.device} and {f.device}")
    if f.dtype not in _DTYPES or a.dtype != f.dtype:
        raise ValueError(
            f"CUDA correlation takes float32 or bfloat16, got {a.dtype} and "
            f"{f.dtype}")
    if f.dim() != 4 or tuple(a.shape) != (*f.shape[:3], nk):
        raise ValueError(
            f"CUDA correlation needs (B,H,W,{nk}) and (B,H,W,C) tensors, got "
            f"{tuple(a.shape)} and {tuple(f.shape)}")
    if not (a.is_contiguous() and f.is_contiguous()):
        raise ValueError("CUDA correlation needs NHWC-contiguous tensors")
    if max_disp < 0 or dilation < 1:
        raise ValueError(f"bad max_disp={max_disp} / dilation={dilation}")


def _launch(name: str, a, f, max_disp: int, dilation: int, nk: int,
            out_channels: int):
    """Runs kernel ``name`` on (a, f) and returns its (B,H,W,out_channels)
    output; ``a`` has ``nk`` channels and ``f`` is a (B,H,W,C) feature."""
    _check(a, f, nk, max_disp, dilation)
    b, h, w, c = f.shape
    out = torch.empty((b, h, w, out_channels), dtype=f.dtype, device=f.device)
    lib = _library()
    with torch.cuda.device(f.device):
        stream = torch.cuda.current_stream(f.device).cuda_stream
        err = getattr(lib, name)(
            a.data_ptr(), f.data_ptr(), out.data_ptr(), b, h, w, c,
            max_disp, dilation, _DTYPES[f.dtype], stream)
    if err != 0:
        raise RuntimeError(
            f"{name} launch failed: {lib.corr_error_string(err).decode()} "
            f"(shape {tuple(f.shape)}, max_disp {max_disp}, dilation "
            f"{dilation}, {f.dtype})")
    return out


def _nk2d(max_disp: int) -> int:
    return (2 * max_disp + 1) ** 2


def corr2d_fwd(f1: torch.Tensor, f2: torch.Tensor, max_disp: int,
               dilation: int = 1) -> torch.Tensor:
    """(B,H,W,C) x2 -> (B,H,W,(2*max_disp+1)**2) on the CUDA kernel."""
    global corr2d_fwd_launches
    out = _launch("corr2d_fwd", f1, f2, max_disp, dilation, f2.shape[-1],
                  _nk2d(max_disp))
    corr2d_fwd_launches += 1
    return out


def corr1d_fwd(f1: torch.Tensor, f2: torch.Tensor, max_disp: int,
               dilation: int = 1) -> torch.Tensor:
    """(B,H,W,C) x2 -> (B,H,W,max_disp+1) on the CUDA kernel."""
    global corr1d_fwd_launches
    out = _launch("corr1d_fwd", f1, f2, max_disp, dilation, f2.shape[-1],
                  max_disp + 1)
    corr1d_fwd_launches += 1
    return out


def corr2d_bwd_f1(g: torch.Tensor, f2: torch.Tensor, max_disp: int,
                  dilation: int = 1) -> torch.Tensor:
    """Gradient of the 2-D op for f1, from g (B,H,W,(2d+1)**2) and f2."""
    global corr2d_bwd_f1_launches
    out = _launch("corr2d_bwd_f1", g, f2, max_disp, dilation,
                  _nk2d(max_disp), f2.shape[-1])
    corr2d_bwd_f1_launches += 1
    return out


def corr2d_bwd_f2(g: torch.Tensor, f1: torch.Tensor, max_disp: int,
                  dilation: int = 1) -> torch.Tensor:
    """Gradient of the 2-D op for f2, from g (B,H,W,(2d+1)**2) and f1."""
    global corr2d_bwd_f2_launches
    out = _launch("corr2d_bwd_f2", g, f1, max_disp, dilation,
                  _nk2d(max_disp), f1.shape[-1])
    corr2d_bwd_f2_launches += 1
    return out


def corr1d_bwd_f1(g: torch.Tensor, f2: torch.Tensor, max_disp: int,
                  dilation: int = 1) -> torch.Tensor:
    """Gradient of the 1-D op for f1, from g (B,H,W,max_disp+1) and f2."""
    global corr1d_bwd_f1_launches
    out = _launch("corr1d_bwd_f1", g, f2, max_disp, dilation, max_disp + 1,
                  f2.shape[-1])
    corr1d_bwd_f1_launches += 1
    return out


def corr1d_bwd_f2(g: torch.Tensor, f1: torch.Tensor, max_disp: int,
                  dilation: int = 1) -> torch.Tensor:
    """Gradient of the 1-D op for f2, from g (B,H,W,max_disp+1) and f1."""
    global corr1d_bwd_f2_launches
    out = _launch("corr1d_bwd_f2", g, f1, max_disp, dilation, max_disp + 1,
                  f1.shape[-1])
    corr1d_bwd_f2_launches += 1
    return out

"""Wrappers for the hand-written CUDA encoder-level kernels
(csrc/encoder_level.cu).

Each wrapper replaces one TPU kernel of
``cerberusnet_tpu/ops/pallas/encoder_level.py``:

  encoder_level_fwd  _level_kernel        one whole pyramid level (stride-2
                                          conv, two stride-1 convs, each
                                          with LeakyReLU(0.1))
  encoder_level_bwd  _level_bwd_kernel    its reverse sweep: dx, dk1..dk3,
                                          db1..db3

The source note in ``csrc/encoder_level.cu`` gives their bound on an H100
and what their design does about it. Their plain PyTorch versions are
``encoder_level_plain`` and ``encoder_level_bwd_plain`` in
``cerberusnet_torch/ops/encoder_level.py``.

Layouts: x (B, H, W, C) and the level's output (B, H/2, W/2, F) are
NHWC-contiguous; the kernels k1 (3, 3, C, F) and k2, k3 (3, 3, F, F) are
HWIO-contiguous and the biases (F,), all CUDA tensors of one type, float32
or bfloat16. A wrapper allocates its outputs with ``torch.empty``, launches
on the current stream without synchronising, and raises on anything the
kernel does not take or on a refused launch. Each kernel has its launch
counter, ``<name>_launches``; nothing else changes them.
"""

from __future__ import annotations

import ctypes

import torch

from cerberusnet_torch.ops import build

encoder_level_fwd_launches = 0
encoder_level_bwd_launches = 0

KERNELS = ("encoder_level_fwd", "encoder_level_bwd")
REPLACES = {
    "encoder_level_fwd": "cerberusnet_tpu/ops/pallas/encoder_level.py:219 "
                         "(_level_kernel, pallas_call at :374)",
    "encoder_level_bwd": "cerberusnet_tpu/ops/pallas/encoder_level.py:505 "
                         "(_level_bwd_kernel, pallas_call at :766)",
}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I = ctypes.c_void_p, ctypes.c_int


def launches() -> dict:
    """{kernel name: launches so far}."""
    return {name: globals()[f"{name}_launches"] for name in KERNELS}


def reset_launches():
    for name in KERNELS:
        globals()[f"{name}_launches"] = 0


def _library() -> ctypes.CDLL:
    lib = build.load("encoder_level")
    if lib.encoder_level_fwd.argtypes is None:
        lib.encoder_level_fwd.argtypes = [_P] * 8 + [_I] * 7 + [_P]
        lib.encoder_level_bwd.argtypes = [_P] * 19 + [_I] * 7 + [_P]
        for fn in (lib.encoder_level_fwd, lib.encoder_level_bwd,
                   lib.encoder_level_fwd_tile, lib.encoder_level_bwd_tile):
            fn.restype = ctypes.c_int
        lib.encoder_level_fwd_tile.argtypes = [_I] * 3
        lib.encoder_level_bwd_tile.argtypes = [_I] * 3
        lib.encoder_level_error_string.argtypes = [_I]
        lib.encoder_level_error_string.restype = ctypes.c_char_p
    return lib


def _check(x, kernels, acts=()):
    """x (B,H,W,C); kernels (k1, b1, k2, b2, k3, b3); acts: tensors of the
    level's output shape (y3, g)."""
    k1 = kernels[0]
    if x.dim() != 4 or k1.dim() != 4:
        raise ValueError(f"encoder level needs x (B,H,W,C) and HWIO kernels, "
                         f"got {tuple(x.shape)} and {tuple(k1.shape)}")
    b, h, w, c = x.shape
    f = k1.shape[-1]
    if h % 2 or w % 2:
        raise ValueError(f"CUDA encoder level needs even H and W: "
                         f"{tuple(x.shape)}")
    want = [(3, 3, c, f), (f,), (3, 3, f, f), (f,), (3, 3, f, f), (f,)]
    got = [tuple(t.shape) for t in kernels]
    if got != [tuple(s) for s in want]:
        raise ValueError(f"encoder level kernels and biases {got}, expected "
                         f"{want}")
    for t in acts:
        if tuple(t.shape) != (b, h // 2, w // 2, f):
            raise ValueError(f"encoder level activation {tuple(t.shape)}, "
                             f"expected {(b, h // 2, w // 2, f)}")
    tensors = (x, *kernels, *acts)
    if x.device.type != "cuda" or any(t.device != x.device for t in tensors):
        raise ValueError("CUDA encoder level needs every tensor on one CUDA "
                         "device")
    if x.dtype not in _DTYPES or any(t.dtype != x.dtype for t in tensors):
        raise ValueError(f"CUDA encoder level takes float32 or bfloat16 "
                         f"tensors of one type, got "
                         f"{sorted({str(t.dtype) for t in tensors})}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("CUDA encoder level needs NHWC-contiguous "
                         "activations and HWIO-contiguous kernels")
    return b, h, w, c, f


def _tile(lib, which, c, f, x):
    t = getattr(lib, f"encoder_level_{which}_tile")(c, f, x.element_size())
    if t <= 0:
        raise ValueError(f"encoder level ({c} -> {f} channels, {x.dtype}) "
                         f"does not fit a block's shared memory")
    return t


def _raise_on(lib, err, name, x, f):
    if err != 0:
        raise RuntimeError(
            f"{name} launch failed: "
            f"{lib.encoder_level_error_string(err).decode()} (x "
            f"{tuple(x.shape)}, F {f}, {x.dtype})")


def _fwd(x, kernels):
    """Checks and launches the forward kernel; returns its output."""
    b, h, w, c, f = _check(x, kernels)
    lib = _library()
    t = _tile(lib, "fwd", c, f, x)
    out = torch.empty((b, h // 2, w // 2, f), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.encoder_level_fwd(
            x.data_ptr(), *(k.data_ptr() for k in kernels), out.data_ptr(),
            b, h, w, c, f, t, _DTYPES[x.dtype], stream)
    _raise_on(lib, err, "encoder_level_fwd", x, f)
    return out


def _bwd(x, y3, g, kernels, need_dx):
    """Checks and launches the reverse-sweep kernel; returns its gradients,
    the per-tile partials summed."""
    b, h, w, c, f = _check(x, kernels, (y3, g))
    lib = _library()
    t = _tile(lib, "bwd", c, f, x)
    tiles = b * (-(-(h // 2) // t)) * (-(-(w // 2) // t))
    # the transposed convolutions read each kernel as (3, 3, Cout, Cin)
    kts = [k.permute(0, 1, 3, 2).contiguous() for k in kernels[::2]]
    dx = torch.empty_like(x) if need_dx else None

    def part(*shape):
        return torch.empty((tiles, *shape), dtype=torch.float32,
                           device=x.device)

    parts = [part(3, 3, c, f), part(f), part(3, 3, f, f), part(f),
             part(3, 3, f, f), part(f)]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.encoder_level_bwd(
            x.data_ptr(), y3.data_ptr(), g.data_ptr(),
            *(k.data_ptr() for k in kernels), *(k.data_ptr() for k in kts),
            dx.data_ptr() if need_dx else None,
            *(p.data_ptr() for p in parts),
            b, h, w, c, f, t, _DTYPES[x.dtype], stream)
    _raise_on(lib, err, "encoder_level_bwd", x, f)
    return (dx, *(p.sum(dim=0) for p in parts))


def level_fwd(x, k1, b1, k2, b2, k3, b3) -> torch.Tensor:
    """One level on the CUDA kernel: (B,H,W,C) -> (B,H/2,W/2,F)."""
    global encoder_level_fwd_launches
    out = _fwd(x, (k1, b1, k2, b2, k3, b3))
    encoder_level_fwd_launches += 1
    return out


def level_bwd(x, y3, g, k1, b1, k2, b2, k3, b3, need_dx: bool = True):
    """The level's reverse sweep on the CUDA kernel, from its input x, its
    output y3 and the output's gradient g. Returns (dx, dk1, db1, dk2, db2,
    dk3, db3): dx in x's type (None unless ``need_dx``), the kernels' and
    biases' gradients in float32, HWIO and (F,). The kernel writes them per
    tile; they are summed over the tile axis here."""
    global encoder_level_bwd_launches
    grads = _bwd(x, y3, g, (k1, b1, k2, b2, k3, b3), need_dx)
    encoder_level_bwd_launches += 1
    return grads

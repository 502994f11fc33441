"""Wrappers for the hand-written CUDA encoder-level kernels
(csrc/encoder_level.cu).

Each wrapper replaces one TPU kernel of
``cerberusnet_tpu/ops/pallas/encoder_level.py``:

  encoder_level_fwd  _level_kernel        one whole pyramid level (stride-2
                                          conv, two stride-1 convs, each
                                          with LeakyReLU(0.1))
  encoder_level_bwd  _level_bwd_kernel    its reverse sweep: dx, dk1..dk3,
                                          db1..db3

Two designs sit behind each wrapper, chosen by the type and the widths
alone, never on a failure: bfloat16 at the widths of ``TC_LEVELS`` (the
encoder's levels 1-3) runs the tensor-core kernels, whose weights are packed
into mma fragment order (the forward's by the library on the device, the
reverse sweep's by this module, ``tc_operands``) and whose reverse sweep
walks a fixed schedule of tiles (``schedule``), one weight-gradient slot per
block; float32, and bfloat16 at other widths, run the CUDA-core
kernels, one partial per tile. The source note in ``csrc/encoder_level.cu``
gives their bound on an H100 and what each design does about it. Their
plain PyTorch versions are ``encoder_level_plain`` and
``encoder_level_bwd_plain`` in ``cerberusnet_torch/ops/encoder_level.py``.

Layouts: x (B, H, W, C) and the level's output (B, H/2, W/2, F) are
NHWC-contiguous; the kernels k1 (3, 3, C, F) and k2, k3 (3, 3, F, F) are
HWIO-contiguous and the biases (F,), all CUDA tensors of one type, float32
or bfloat16. A wrapper allocates its outputs with ``torch.empty``, launches
on the current stream without synchronising, and raises on anything the
kernel does not take or on a refused launch. Each kernel has its launch
counter, ``<name>_launches``; nothing else changes them.
``encoder_level_bwd_partial_bytes`` counts the float32 weight-gradient
partials the reverse sweeps allocate, reset with the launch counters.
"""

from __future__ import annotations

import ctypes
import re

import torch
import torch.nn.functional as F

from cerberusnet_torch.ops import build

encoder_level_fwd_launches = 0
encoder_level_bwd_launches = 0
encoder_level_bwd_partial_bytes = 0

KERNELS = ("encoder_level_fwd", "encoder_level_bwd")
REPLACES = {
    "encoder_level_fwd": "cerberusnet_tpu/ops/pallas/encoder_level.py:219 "
                         "(_level_kernel, pallas_call at :374)",
    "encoder_level_bwd": "cerberusnet_tpu/ops/pallas/encoder_level.py:505 "
                         "(_level_bwd_kernel, pallas_call at :766)",
}


# the header that holds TC_LEVELS, which csrc/encoder_level.cu and the C++
# operators (csrc/cerberus_ops.cc) include
TC_LEVELS_HEADER = build.CSRC_DIR / "tc_levels.cuh"


def _tc_rows() -> list:
    """The X(...) rows of the TC_LEVELS table, from which the kernels are
    instantiated: (C, F, forward tile rows, cols, reverse-sweep tile rows,
    cols, reverse-sweep blocks per SM, threads, keep)."""
    text = TC_LEVELS_HEADER.read_text()
    table = text[text.index("#define TC_LEVELS(X)"):].splitlines()[1:]
    rows = []
    for line in table:
        m = re.match(r"\s*X\(([\d,\s]+)\)", line)
        if m is None:
            break
        rows.append(tuple(int(v) for v in m.group(1).split(",")))
    return rows


# (C, F): (forward tile (rows, cols), reverse-sweep tile (rows, cols),
# reverse-sweep blocks per SM) of the bfloat16 tensor-core kernels, read
# from the table. A tile is as large as shared memory allows with two
# forward blocks on an SM; the reverse sweep's takes most of an SM at levels
# 2-3, so one block runs there. TC_KEPT: the widths whose reverse sweep
# keeps a block's weight gradients in registers across its tiles (the rest
# update the block's slot in device memory).
TC_LEVELS = {(r[0], r[1]): ((r[2], r[3]), (r[4], r[5]), r[6])
             for r in _tc_rows()}
TC_KEPT = frozenset((r[0], r[1]) for r in _tc_rows() if r[8])
H100_SMS = 132

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I = ctypes.c_void_p, ctypes.c_int
_schedules: dict = {}
_gathers: dict = {}


def launches() -> dict:
    """{kernel name: launches so far}."""
    return {name: globals()[f"{name}_launches"] for name in KERNELS}


def reset_launches():
    """Zeroes the launch counters and ``encoder_level_bwd_partial_bytes``."""
    global encoder_level_bwd_partial_bytes
    for name in KERNELS:
        globals()[f"{name}_launches"] = 0
    encoder_level_bwd_partial_bytes = 0


def _library() -> ctypes.CDLL:
    lib = build.load("encoder_level")
    if lib.encoder_level_fwd.argtypes is None:
        lib.encoder_level_fwd.argtypes = [_P] * 8 + [_I] * 7 + [_P]
        lib.encoder_level_bwd.argtypes = [_P] * 19 + [_I] * 7 + [_P]
        lib.encoder_level_tc_fwd.argtypes = [_P] * 9 + [_I] * 7 + [_P]
        lib.encoder_level_tc_fwd_pack.argtypes = [_P] * 4 + [_I] * 2 + [_P]
        lib.encoder_level_tc_fwd_pack.restype = ctypes.c_int
        lib.encoder_level_tc_fwd_workspace.argtypes = [_I] * 2
        lib.encoder_level_tc_fwd_workspace.restype = ctypes.c_int64
        lib.encoder_level_tc_bwd.argtypes = [_P] * 13 + [_I] * 8 + [_P]
        for fn in (lib.encoder_level_fwd, lib.encoder_level_bwd,
                   lib.encoder_level_tc_fwd, lib.encoder_level_tc_bwd,
                   lib.encoder_level_fwd_tile, lib.encoder_level_bwd_tile):
            fn.restype = ctypes.c_int
        lib.encoder_level_fwd_tile.argtypes = [_I] * 3
        lib.encoder_level_bwd_tile.argtypes = [_I] * 3
        for fn in (lib.encoder_level_tc_smem,
                   lib.encoder_level_tc_blocks_per_sm):
            fn.argtypes = [_I] * 3
            fn.restype = ctypes.c_int
        lib.encoder_level_error_string.argtypes = [_I]
        lib.encoder_level_error_string.restype = ctypes.c_char_p
    return lib


# ------------------------------------------- tensor-core operands (plain)


def uses_tensor_cores(dtype, c: int, f: int) -> bool:
    """Whether a level of these widths and type runs the tensor-core
    kernels (else the CUDA-core ones)."""
    return dtype == torch.bfloat16 and (c, f) in TC_LEVELS


def pack_b(w: torch.Tensor) -> torch.Tensor:
    """Weights (T, K, N) as mma.m16n8k16 B fragments: K padded to a
    multiple of 16 and N to 8 with zeros, then (T, K/16, N/8, 32 lanes, 4):
    lane 4g + q holds rows 2q, 2q+1, 2q+8, 2q+9 of column g of each 16 x 8
    block, the first two in its first 32-bit register, lowest row in the low
    half."""
    t, k, n = w.shape
    kp, np_ = -(-k // 16) * 16, -(-n // 8) * 8
    w = F.pad(w, (0, np_ - n, 0, kp - k))
    # k = 16 kc + 8 h + 2 q + e, n = 8 nt + g
    w = w.reshape(t, kp // 16, 2, 4, 2, np_ // 8, 8)
    return w.permute(0, 1, 5, 6, 3, 2, 4).contiguous()


def tc_operands(k1, k2, k3):
    """The packed B operands of the tensor-core kernels from the HWIO
    kernels: the forward convolutions as (tap, Cin, F) (level 1's entry
    conv, C = 3, as one tap of 27 im2col rows, k = 3 (3 ky + kx) + c); the
    transposed ones, k3t and k2t, with taps flipped as (tap, F out, F in);
    and dx's k1t as (tap, F, C)."""
    c, f = k1.shape[2], k1.shape[3]

    def flipped(k):
        return k.flip(0, 1).transpose(2, 3).reshape(9, f, f)

    entry = k1.reshape(1, 9 * c, f) if c == 3 else k1.reshape(9, c, f)
    return {"k1": pack_b(entry), "k2": pack_b(k2.reshape(9, f, f)),
            "k3": pack_b(k3.reshape(9, f, f)), "k3t": pack_b(flipped(k3)),
            "k2t": pack_b(flipped(k2)),
            "k1t": pack_b(k1.transpose(2, 3).reshape(9, f, c))}


def packed_operands(k1, k2, k3, names) -> dict:
    """tc_operands' operands ``names`` as one gather from the three
    kernels: the positions of each packed value in (0, k1, k2, k3)
    flattened are found once per widths and device by packing positions
    with tc_operands itself; a call then costs one concatenation and one
    gather (padding reads the 0)."""
    c, f = k1.shape[2], k1.shape[3]
    key = (c, f, names, str(k1.device))
    if key not in _gathers:
        n1, n2 = 9 * c * f, 9 * f * f
        pos = torch.arange(1, 1 + n1 + 2 * n2, dtype=torch.float64)
        ops = tc_operands(pos[:n1].view(3, 3, c, f),
                          pos[n1:n1 + n2].view(3, 3, f, f),
                          pos[n1 + n2:].view(3, 3, f, f))
        idx = torch.cat([ops[n].flatten() for n in names]).long()
        _gathers[key] = (idx.to(k1.device), [ops[n].numel() for n in names],
                         [ops[n].shape for n in names])
    idx, sizes, shapes = _gathers[key]
    src = torch.cat([k1.new_zeros(1), k1.flatten(), k2.flatten(),
                     k3.flatten()])
    parts = src[idx].split(sizes)
    return {n: v.view(s) for n, v, s in zip(names, parts, shapes)}


def tile_count(b: int, h: int, w: int, tile) -> int:
    """Tiles of a (th, tw) tile over the level's (H/2, W/2) output, per
    batch."""
    th, tw = tile
    return b * (-(-(h // 2) // th)) * (-(-(w // 2) // tw))


def schedule(n_tiles: int, slots: int) -> list:
    """The persistent reverse sweep's schedule: block i walks tiles
    s[i] .. s[i+1] - 1, a contiguous run; runs differ by at most one tile,
    and every block has one when slots <= n_tiles."""
    base, extra = divmod(n_tiles, slots)
    return [i * base + min(i, extra) for i in range(slots + 1)]


def bwd_plan(b: int, h: int, w: int, c: int, f: int, sms: int = H100_SMS):
    """(tile, slots, schedule) of the tensor-core reverse sweep: at most
    blocks-per-SM x SMs slots, never more than the tiles."""
    _, tile, per_sm = TC_LEVELS[(c, f)]
    n_tiles = tile_count(b, h, w, tile)
    slots = min(n_tiles, per_sm * sms)
    return tile, slots, schedule(n_tiles, slots)


def slot_floats(c: int, f: int) -> int:
    """float32 values of one weight-gradient slot: dk1, dk2, dk3, db1..3."""
    return 9 * c * f + 2 * 9 * f * f + 3 * f


def _cuda_core_tile(c, f, dtype, which):
    t = getattr(_library(), f"encoder_level_{which}_tile")(
        c, f, torch.empty((), dtype=dtype).element_size())
    if t <= 0:
        raise ValueError(f"encoder level ({c} -> {f} channels, {dtype}) "
                         f"does not fit a block's shared memory")
    return t


# ------------------------------------------------------------- launches


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
    if uses_tensor_cores(x.dtype, c, f) and any(
            t.data_ptr() % 16 for t in (x, *acts)):
        raise ValueError("the tensor-core encoder level reads activations "
                         "16 bytes at a time: they must start 16-byte "
                         "aligned")
    return b, h, w, c, f


def _raise_on(lib, err, name, x, f):
    if err != 0:
        raise RuntimeError(
            f"{name} launch failed: "
            f"{lib.encoder_level_error_string(err).decode()} (x "
            f"{tuple(x.shape)}, F {f}, {x.dtype})")


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def _tc_fwd_workspace(lib, c, f, x):
    """The device bytes the tensor-core forward packs its weights into."""
    return torch.empty(lib.encoder_level_tc_fwd_workspace(c, f),
                       dtype=torch.uint8, device=x.device)


def tc_fwd_device_operands(k1, k2, k3) -> torch.Tensor:
    """The forward's k1, k2, k3 as the library packs them on the device
    (``encoder_level_tc_fwd_pack``), one after another, flat bfloat16: the
    check that keeps the library's forward packing and ``pack_b`` in step
    holds it equal to ``tc_operands``' k1, k2, k3 flattened."""
    c, f = k1.shape[2], k1.shape[3]
    lib = _library()
    ws = _tc_fwd_workspace(lib, c, f, k1)
    with torch.cuda.device(k1.device):
        err = lib.encoder_level_tc_fwd_pack(
            k1.data_ptr(), k2.data_ptr(), k3.data_ptr(), ws.data_ptr(), c, f,
            _stream(k1))
    _raise_on(lib, err, "encoder_level_tc_fwd_pack", k1, f)
    return ws.view(torch.bfloat16)


def _fwd(x, kernels):
    """Checks and launches the forward kernel; returns its output."""
    b, h, w, c, f = _check(x, kernels)
    lib = _library()
    out = torch.empty((b, h // 2, w // 2, f), dtype=x.dtype, device=x.device)
    k1, b1, k2, b2, k3, b3 = kernels
    with torch.cuda.device(x.device):
        if uses_tensor_cores(x.dtype, c, f):
            # the library packs the weights into mma fragment order here
            (th, tw), _, _ = TC_LEVELS[(c, f)]
            err = lib.encoder_level_tc_fwd(
                x.data_ptr(), *(k.data_ptr() for k in kernels),
                out.data_ptr(), _tc_fwd_workspace(lib, c, f, x).data_ptr(),
                b, h, w, c, f, th, tw, _stream(x))
        else:
            t = _cuda_core_tile(c, f, x.dtype, "fwd")
            err = lib.encoder_level_fwd(
                x.data_ptr(), *(k.data_ptr() for k in kernels),
                out.data_ptr(), b, h, w, c, f, t, _DTYPES[x.dtype],
                _stream(x))
    _raise_on(lib, err, "encoder_level_fwd", x, f)
    return out


def _device_schedule(sched, device):
    """The schedule as an int32 tensor on the device, made once per schedule
    and device (a copy from the host would wait for the stream)."""
    key = (tuple(sched), str(device))
    if key not in _schedules:
        _schedules[key] = torch.tensor(sched, dtype=torch.int32, device=device)
    return _schedules[key]


def _split_slots(slots, c, f):
    """(dk1, db1, dk2, db2, dk3, db3) from the slots, summed over blocks in
    a fixed order."""
    s = slots.sum(dim=0)
    n1, n2 = 9 * c * f, 9 * f * f
    dk1, dk2, dk3 = s[:n1], s[n1:n1 + n2], s[n1 + n2:n1 + 2 * n2]
    db = s[n1 + 2 * n2:].view(3, f)
    return (dk1.view(3, 3, c, f), db[0], dk2.view(3, 3, f, f), db[1],
            dk3.view(3, 3, f, f), db[2])


def _bwd(x, y3, g, kernels, need_dx):
    """Checks and launches the reverse-sweep kernel; returns its gradients,
    the weight-gradient partials summed."""
    global encoder_level_bwd_partial_bytes
    b, h, w, c, f = _check(x, kernels, (y3, g))
    lib = _library()
    dx = torch.empty_like(x) if need_dx else None
    k1, b1, k2, b2, k3, b3 = kernels
    with torch.cuda.device(x.device):
        if uses_tensor_cores(x.dtype, c, f):
            sms = torch.cuda.get_device_properties(
                x.device).multi_processor_count
            (th, tw), blocks, sched = bwd_plan(b, h, w, c, f, sms)
            ops = packed_operands(k1, k2, k3,
                                  ("k1", "k2", "k3t", "k2t", "k1t"))
            slots = torch.empty((blocks, slot_floats(c, f)),
                                dtype=torch.float32, device=x.device)
            err = lib.encoder_level_tc_bwd(
                x.data_ptr(), y3.data_ptr(), g.data_ptr(),
                ops["k1"].data_ptr(), b1.data_ptr(), ops["k2"].data_ptr(),
                b2.data_ptr(), ops["k3t"].data_ptr(), ops["k2t"].data_ptr(),
                ops["k1t"].data_ptr(), dx.data_ptr() if need_dx else None,
                slots.data_ptr(), _device_schedule(sched, x.device).data_ptr(),
                blocks, b, h, w, c, f, th, tw, _stream(x))
            _raise_on(lib, err, "encoder_level_bwd", x, f)
            encoder_level_bwd_partial_bytes += slots.nbytes
            return (dx, *_split_slots(slots, c, f))
        t = _cuda_core_tile(c, f, x.dtype, "bwd")
        tiles = tile_count(b, h, w, (t, t))
        # the transposed convolutions read each kernel as (3, 3, Cout, Cin)
        kts = [k.permute(0, 1, 3, 2).contiguous() for k in kernels[::2]]

        def part(*shape):
            return torch.empty((tiles, *shape), dtype=torch.float32,
                               device=x.device)

        parts = [part(3, 3, c, f), part(f), part(3, 3, f, f), part(f),
                 part(3, 3, f, f), part(f)]
        err = lib.encoder_level_bwd(
            x.data_ptr(), y3.data_ptr(), g.data_ptr(),
            *(k.data_ptr() for k in kernels), *(k.data_ptr() for k in kts),
            dx.data_ptr() if need_dx else None,
            *(p.data_ptr() for p in parts),
            b, h, w, c, f, t, _DTYPES[x.dtype], _stream(x))
    _raise_on(lib, err, "encoder_level_bwd", x, f)
    encoder_level_bwd_partial_bytes += sum(p.nbytes for p in parts)
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
    block (tensor cores) or per tile (CUDA cores); they are summed here."""
    global encoder_level_bwd_launches
    grads = _bwd(x, y3, g, (k1, b1, k2, b2, k3, b3), need_dx)
    encoder_level_bwd_launches += 1
    return grads

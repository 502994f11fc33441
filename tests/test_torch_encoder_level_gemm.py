"""The tensor-core design of the fused encoder level (csrc/encoder_level.cu,
bfloat16 at the widths of ``TC_LEVELS``), held on the CPU where the kernels
cannot run.

An im2col-GEMM emulation of the level and of its reverse sweep, written
here from the wrapper's packed operands: each packed weight is read back
lane by lane as mma.m16n8k16 hands B to a lane (PTX ISA, "Matrix Fragments
for mma.m16n8k16"), so a wrong packing order shows as a wrong level. The
products run in the kernels' K order (tap-major, level 1's 27 im2col
values padded to 32) with the kernels' rounding points: every value a
float32 sum rounded once to the working type, y1, y2 and g1..g3 held in it.
In float32 the emulation must give the plain level and its gradients
(``encoder_level_plain``, ``encoder_level_bwd_plain``) within 1e-5
(relative L2: only the summation order differs); in bfloat16 it must stay
within 1.5x the plain bf16 level's distance to the float32 one plus 1e-3,
the rule chip_smoke.py holds the kernels to. Also the persistent reverse
sweep's schedule and slot count at the 512x1024 level shapes, the tile
table the wrapper reads from the source, and the source's measurement
builds (cerberusnet_torch/level_phases.py). The forward's weights are
packed by the library on the device (csrc/tc_pack.cuh): that kernel,
compiled here with g++ and run one thread at a time, must pack as pack_b
does, bit for bit.
"""

import ctypes
import subprocess

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from cerberusnet_torch import level_phases
from cerberusnet_torch.ops import build
from cerberusnet_torch.ops.cuda import encoder_level as cl
from cerberusnet_torch.ops.encoder_level import (
    encoder_level_bwd_plain,
    encoder_level_plain,
)
from cerberusnet_torch.testing import one_torch_thread  # noqa: F401



WIDTHS = sorted(cl.TC_LEVELS)  # (3, 16), (16, 32), (32, 64)
# small extents; (14, 22) gives a 7 x 11 output, no multiple of any tile
EXTENTS = [(2, 8, 12), (1, 14, 22)]
GRADS = ("dx", "dk1", "db1", "dk2", "db2", "dk3", "db3")


def level_inputs(b, h, w, c, f, seed):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(b, h, w, c).astype(np.float32))
    params = []
    for cin in (c, f, f):
        params.append(torch.from_numpy(
            (rng.randn(3, 3, cin, f) / np.sqrt(9 * cin)).astype(np.float32)))
        params.append(torch.from_numpy(
            (0.1 * rng.randn(f)).astype(np.float32)))
    g = torch.from_numpy(rng.randn(b, h // 2, w // 2, f).astype(np.float32))
    return x, params, g


def rel_l2(a, ref):
    a, ref = a.double(), ref.double()
    return ((a - ref).norm() / ref.norm().clamp_min(1e-30)).item()


# ------------------------------------------------------------ emulation


def unpack_b(packed, k, n):
    """(T, K, N) from pack_b's fragments, read as mma.m16n8k16 hands them
    to lanes: lane l holds column l // 4 of each 16 x 8 block of B, its
    register r rows 8r + 2 (l % 4) and the next, the lower row in the low
    16 bits."""
    t, kc, nt = packed.shape[:3]
    frags = packed.reshape(t, kc, nt, 32, 4)
    out = torch.zeros(t, 16 * kc, 8 * nt, dtype=packed.dtype)
    for lane in range(32):
        for reg in range(2):
            for half in range(2):
                row = 8 * reg + 2 * (lane % 4) + half
                col = lane // 4
                for i in range(kc):
                    for j in range(nt):
                        out[:, 16 * i + row, 8 * j + col] = \
                            frags[:, i, j, lane, 2 * reg + half]
    return out[:, :k, :n]


def taps(v, stride):
    """(B, H', W', 9, C): v (B, H, W, C) at each output pixel's nine taps,
    tap = 3 ky + kx, zero outside; SAME (stride 2 on an even extent pads
    (0, 1), stride 1 pads (1, 1))."""
    if stride == 2:
        p = F.pad(v, (0, 0, 0, 1, 0, 1))
        ho, wo = v.shape[1] // 2, v.shape[2] // 2
        return torch.stack([p[:, ky:ky + 2 * ho:2, kx:kx + 2 * wo:2]
                            for ky in range(3) for kx in range(3)], dim=3)
    p = F.pad(v, (0, 0, 1, 1, 1, 1))
    h, w = v.shape[1], v.shape[2]
    return torch.stack([p[:, ky:ky + h, kx:kx + w]
                        for ky in range(3) for kx in range(3)], dim=3)


def gemm(a_rows, b):
    """float32 sum of a_rows (..., K) @ b (K, N), bf16 operands exact in
    float32."""
    return a_rows.float() @ b.float()


def emulate_level(x, params, ops):
    """(y1, y2, y3) of the level as the kernels compute it, from the packed
    operands: every product a float32 GEMM in tap-major K order, each output
    rounded once to x's type. The returned y1, y2 are the kernels'."""
    k1, b1, k2, b2, k3, b3 = params
    c, f = k1.shape[2], k1.shape[3]
    leaky = lambda v: torch.where(v > 0, v, 0.1 * v)  # noqa: E731
    kp = 32 if c == 3 else c
    b1m = unpack_b(ops["k1"], kp if c == 3 else c, f)
    rows = taps(x, 2).flatten(3)  # k = 3 (3 ky + kx) + c, or tap C + c
    if c == 3:
        rows = F.pad(rows, (0, 5))  # 27 im2col values and 5 zeros
        b1m = b1m.reshape(32, f)
    else:
        b1m = b1m.reshape(9 * c, f)
    y1 = leaky(gemm(rows, b1m) + b1.float()).to(x.dtype)
    b2m = unpack_b(ops["k2"], f, f).reshape(9 * f, f)
    y2 = leaky(gemm(taps(y1, 1).flatten(3), b2m) + b2.float()).to(x.dtype)
    b3m = unpack_b(ops["k3"], f, f).reshape(9 * f, f)
    y3 = leaky(gemm(taps(y2, 1).flatten(3), b3m) + b3.float()).to(x.dtype)
    return y1, y2, y3


def emulate_bwd(x, y3, g, params, ops):
    """(dx, dk1, db1, dk2, db2, dk3, db3) as the reverse sweep computes
    them: y1, y2 recomputed; g3, g2, g1 rounded to x's type; the
    transposed convolutions with the flipped packed taps; dx by parity
    class; dk and db float32."""
    k1 = params[0]
    c, f = k1.shape[2], k1.shape[3]
    dt = x.dtype
    mask = lambda y: torch.where(y.float() > 0, 1.0, 0.1)  # noqa: E731
    y1, y2, _ = emulate_level(x, params, ops)
    g3 = (g.float() * mask(y3)).to(dt)

    def wgrad(rows, gv):  # sum over pixels of rows^T gv
        return rows.flatten(0, 2).float().T @ gv.flatten(0, 2).float()

    dk3 = wgrad(taps(y2, 1).flatten(3), g3).reshape(3, 3, f, f)
    k3t = unpack_b(ops["k3t"], f, f).reshape(9 * f, f)
    g2 = (gemm(taps(g3, 1).flatten(3), k3t) * mask(y2)).to(dt)
    dk2 = wgrad(taps(y1, 1).flatten(3), g2).reshape(3, 3, f, f)
    k2t = unpack_b(ops["k2t"], f, f).reshape(9 * f, f)
    g1 = (gemm(taps(g2, 1).flatten(3), k2t) * mask(y1)).to(dt)
    dk1 = wgrad(taps(x, 2).flatten(3), g1).reshape(3, 3, c, f)
    # dx(2u + a, 2v + e) = sum over the class's taps of g1(u + (a - ky)/2,
    # v + (e - kx)/2) k1t[tap]
    k1t = unpack_b(ops["k1t"], f, c)
    b, h2, w2, _ = g1.shape
    gp = F.pad(g1, (0, 0, 1, 0, 1, 0))  # g1 at -1 is 0
    dx = torch.zeros(b, 2 * h2, 2 * w2, c)
    for a in (0, 1):
        for e in (0, 1):
            acc = torch.zeros(b, h2, w2, c)
            for ky in ((1,) if a else (0, 2)):
                for kx in ((1,) if e else (0, 2)):
                    dy, dxo = (a - ky) // 2, (e - kx) // 2
                    src = gp[:, 1 + dy:1 + dy + h2, 1 + dxo:1 + dxo + w2]
                    acc += gemm(src, k1t[3 * ky + kx])
            dx[:, a::2, e::2] = acc
    return (dx.to(dt), dk1, g1.float().sum((0, 1, 2)), dk2,
            g2.float().sum((0, 1, 2)), dk3, g3.float().sum((0, 1, 2)))


# ---------------------------------------------------------------- tests


def test_pack_b_puts_each_value_where_a_lane_reads_it():
    w = torch.arange(2 * 27 * 12, dtype=torch.float32).reshape(2, 27, 12)
    packed = cl.pack_b(w)
    assert packed.shape == (2, 2, 2, 8, 4, 2, 2)  # K -> 32, N -> 16
    back = unpack_b(packed, 32, 16)
    assert torch.equal(back[:, :27, :12], w)
    assert not back[:, 27:].any() and not back[:, :, 12:].any()


@pytest.mark.parametrize("widths", WIDTHS, ids=str)
def test_tc_operands_shapes(widths):
    c, f = widths
    _, params, _ = level_inputs(1, 4, 4, c, f, seed=0)
    ops = cl.tc_operands(params[0], params[2], params[4])
    kc1 = 2 if c == 3 else c // 16
    assert ops["k1"].shape == ((1 if c == 3 else 9), kc1, f // 8, 8, 4, 2, 2)
    for name in ("k2", "k3", "k3t", "k2t"):
        assert ops[name].shape == (9, f // 16, f // 8, 8, 4, 2, 2)
    assert ops["k1t"].shape == (9, f // 16, -(-c // 8), 8, 4, 2, 2)
    # the transposed operands are the forward ones with taps flipped
    k3 = unpack_b(ops["k3"], f, f).reshape(3, 3, f, f)
    k3t = unpack_b(ops["k3t"], f, f).reshape(3, 3, f, f)
    assert torch.equal(k3t, k3.flip(0, 1).transpose(2, 3))


@pytest.mark.parametrize("widths", WIDTHS, ids=str)
def test_one_gather_packs_as_tc_operands(widths):
    _, params, _ = level_inputs(1, 4, 4, *widths, seed=5)
    params = [p.bfloat16() for p in params]
    want = cl.tc_operands(params[0], params[2], params[4])
    for names in (("k1", "k2", "k3"), ("k1", "k2", "k3t", "k2t", "k1t")):
        got = cl.packed_operands(params[0], params[2], params[4], names)
        assert list(got) == list(names)
        for n in names:
            assert torch.equal(got[n], want[n]), n


# tc_pack.cuh on the CPU: the kernel's qualifiers dropped and its grid
# walked by a loop, one thread at a time
PACK_HARNESS = r"""
#include <stdint.h>
#define __global__
#define __host__
#define __device__
struct Dim3 { unsigned x, y, z; };
static Dim3 blockIdx, gridDim, blockDim, threadIdx;
#include "tc_pack.cuh"
extern "C" int64_t packed_elems_of(int C, int F) {
  return tc_fwd_packed_elems(C, F);
}
extern "C" void pack(const void* k1, const void* k2, const void* k3,
                     void* out, int C, int F) {
  const TcFwdOperands ops = tc_fwd_operands(k1, k2, k3, out, C, F);
  blockDim = {64, 1, 1};
  gridDim = {3, 3, 1};  // fewer threads than values: the stride loop runs
  for (blockIdx.y = 0; blockIdx.y < 3; ++blockIdx.y)
    for (blockIdx.x = 0; blockIdx.x < gridDim.x; ++blockIdx.x)
      for (threadIdx.x = 0; threadIdx.x < blockDim.x; ++threadIdx.x)
        tc_pack_kernel(ops);
}
"""


@pytest.fixture(scope="module")
def cpu_pack(tmp_path_factory):
    d = tmp_path_factory.mktemp("tc_pack")
    (d / "harness.cc").write_text(PACK_HARNESS)
    subprocess.run(["g++", "-O1", "-shared", "-fPIC", "-I",
                    str(build.CSRC_DIR), "-o", str(d / "pack.so"),
                    str(d / "harness.cc")], check=True)
    lib = ctypes.CDLL(str(d / "pack.so"))
    lib.packed_elems_of.restype = ctypes.c_int64
    lib.packed_elems_of.argtypes = [ctypes.c_int] * 2
    lib.pack.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2
    return lib


@pytest.mark.parametrize("widths", WIDTHS, ids=str)
def test_device_forward_packing_is_pack_b(cpu_pack, widths):
    c, f = widths
    _, params, _ = level_inputs(1, 4, 4, c, f, seed=7)
    k1, k2, k3 = (params[i].bfloat16() for i in (0, 2, 4))
    want = cl.tc_operands(k1, k2, k3)
    want = torch.cat([want[n].flatten() for n in ("k1", "k2", "k3")])
    got = torch.full((cpu_pack.packed_elems_of(c, f),), float("nan"),
                     dtype=torch.bfloat16)
    cpu_pack.pack(k1.data_ptr(), k2.data_ptr(), k3.data_ptr(),
                  got.data_ptr(), c, f)
    assert got.shape == want.shape
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


@pytest.mark.parametrize("extent", EXTENTS, ids=str)
@pytest.mark.parametrize("widths", WIDTHS, ids=str)
def test_emulated_level_f32_matches_plain(widths, extent):
    x, params, _ = level_inputs(*extent, *widths, seed=1)
    ops = cl.tc_operands(params[0], params[2], params[4])
    *_, y3 = emulate_level(x, params, ops)
    want = encoder_level_plain(x, *params)
    assert rel_l2(y3, want) <= 1e-5


@pytest.mark.parametrize("extent", EXTENTS, ids=str)
@pytest.mark.parametrize("widths", WIDTHS, ids=str)
def test_emulated_reverse_sweep_f32_matches_plain(widths, extent):
    x, params, g = level_inputs(*extent, *widths, seed=2)
    ops = cl.tc_operands(params[0], params[2], params[4])
    y3 = encoder_level_plain(x, *params)
    got = emulate_bwd(x, y3, g, params, ops)
    want = encoder_level_bwd_plain(x, y3, g, *params)
    for name, a, b in zip(GRADS, got, want):
        assert a.shape == b.shape, name
        assert rel_l2(a, b) <= 1e-5, (name, rel_l2(a, b))


@pytest.mark.parametrize("widths", WIDTHS, ids=str)
def test_emulated_level_bf16_within_the_bf16_rule(widths):
    x, params, g = level_inputs(2, 14, 22, *widths, seed=3)
    x16, p16, g16 = x.bfloat16(), [p.bfloat16() for p in params], g.bfloat16()
    x32, p32 = x16.float(), [p.float() for p in p16]
    ops = cl.tc_operands(p16[0], p16[2], p16[4])
    *_, y3 = emulate_level(x16, p16, ops)
    assert y3.dtype == torch.bfloat16
    ref = encoder_level_plain(x32, *p32)
    limit = 1.5 * rel_l2(encoder_level_plain(x16, *p16), ref) + 1e-3
    assert rel_l2(y3, ref) <= limit
    got = emulate_bwd(x16, y3, g16, p16, ops)
    want = encoder_level_bwd_plain(x32, None, g16.float(), *p32)
    plain = encoder_level_bwd_plain(x16, None, g16, *p16)
    for name, a, r, p in zip(GRADS, got, want, plain):
        assert rel_l2(a, r) <= 1.5 * rel_l2(p, r) + 1e-3, name


# the 512x1024 level shapes at batch 6 (a train step) and the odd shape
SCHEDULE_SHAPES = [(6, 512, 1024, 3, 16), (6, 256, 512, 16, 32),
                   (6, 128, 256, 32, 64), (1, 72, 16, 3, 16)]


@pytest.mark.parametrize("shape", SCHEDULE_SHAPES, ids=str)
def test_schedule_owns_every_tile_once(shape):
    b, h, w, c, f = shape
    tile, slots, sched = cl.bwd_plan(b, h, w, c, f)
    n_tiles = cl.tile_count(b, h, w, tile)
    assert sched[0] == 0 and sched[-1] == n_tiles
    runs = [sched[i + 1] - sched[i] for i in range(slots)]
    assert min(runs) >= 1 and max(runs) - min(runs) <= 1
    owned = [t for i in range(slots) for t in range(sched[i], sched[i + 1])]
    assert owned == list(range(n_tiles))
    assert slots <= 2 * cl.H100_SMS
    # the tiles cover the output, and no tile lies wholly outside it
    th, tw = tile
    assert th * (-(-(h // 2) // th)) - h // 2 < th
    assert tw * (-(-(w // 2) // tw)) - w // 2 < tw


def test_partials_one_slot_per_block():
    # CUDA cores: one slot per tile (3072, 768, 768 at batch 6); now at
    # most two per SM per level
    total = 0
    for shape in SCHEDULE_SHAPES[:3]:
        b, h, w, c, f = shape
        _, slots, _ = cl.bwd_plan(b, h, w, c, f)
        per_sm = cl.TC_LEVELS[(c, f)][2]
        assert slots == per_sm * cl.H100_SMS
        total += 4 * slots * cl.slot_floats(c, f)
    assert total < 100e6  # about 417 MB with one slot per tile


def test_partial_bytes_counter_resets_with_the_launches():
    cl.encoder_level_bwd_partial_bytes = 123
    cl.encoder_level_bwd_launches = 2
    cl.reset_launches()
    assert cl.encoder_level_bwd_partial_bytes == 0
    assert cl.launches() == {"encoder_level_fwd": 0, "encoder_level_bwd": 0}


def test_tile_table_is_read_from_the_source():
    # the table lives in a header that the kernels' source includes
    text = cl.TC_LEVELS_HEADER.read_text()
    assert '#include "tc_levels.cuh"' in (
        build.CSRC_DIR / "encoder_level.cu").read_text()
    rows = cl._tc_rows()
    assert [r[:2] for r in rows] == [(3, 16), (16, 32), (32, 64)]
    for row in rows:
        assert len(row) == 9
        # the row as written in the X-macro the kernels are built from
        assert "X(" + ", ".join(map(str, row)) + ")" in text
        c, f, fth, ftw, bth, btw, per_sm, threads, keep = row
        assert cl.TC_LEVELS[(c, f)] == ((fth, ftw), (bth, btw), per_sm)
        assert ((c, f) in cl.TC_KEPT) == bool(keep)
        assert threads % f == 0 and 3 * f <= threads  # the db sums
    # level 3's 369 KB of weight gradients do not fit in the registers
    assert (32, 64) not in cl.TC_KEPT
    assert 4 * cl.slot_floats(32, 64) > 256 * 1024


@pytest.mark.parametrize("kind", ["fwd", "bwd"])
def test_phase_marks_match_the_phase_names(kind):
    # one PHASE_MARK per phase of a level-2/3 tile, one more where level 1
    # stages its im2col rows; the measurement build defines LEVEL_PHASES
    text = (build.CSRC_DIR / "encoder_level.cu").read_text()
    k = {"fwd": 0, "bwd": 1}[kind]
    marks = text.count(f"PHASE_MARK({k});")
    assert marks == len(level_phases.phase_names(kind, 16)) + 1
    assert len(level_phases.phase_names(kind, 3)) == marks
    flags = build.flags(level_phases.MEASUREMENT_BUILDS["phases"])
    assert flags[:len(build.NVCC_FLAGS)] == build.NVCC_FLAGS
    assert flags[len(build.NVCC_FLAGS):] == ("-DLEVEL_PHASES",)
    assert "#ifdef LEVEL_PHASES" in text


def test_measurement_builds_are_separate_libraries():
    paths = {build.library_path("encoder_level", d)
             for d in ((), *level_phases.MEASUREMENT_BUILDS.values())}
    assert len(paths) == 3
    pad = build.flags(level_phases.MEASUREMENT_BUILDS["one_block"])[-1]
    assert pad == f"-DLEVEL_FWD_SMEM_PAD={level_phases.FWD_SMEM_PAD}"


def test_tensor_cores_by_type_and_width_only():
    assert cl.uses_tensor_cores(torch.bfloat16, 16, 32)
    assert not cl.uses_tensor_cores(torch.float32, 16, 32)
    assert not cl.uses_tensor_cores(torch.bfloat16, 3, 8)
    assert not cl.uses_tensor_cores(torch.bfloat16, 64, 96)

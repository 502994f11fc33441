"""Inside the hand-written kernels: phases, slot traffic, residency, and the
correlation kernels' two designs in turns.

    python3 -m cerberusnet_torch.level_phases [--source encoder_level]
                                              [--source correlation]

(both sources without ``--source``). No kernel profiler runs on the H100's
machine, so this builds each source again with its measurement flags and
launches each build through the wrappers in place of the library.

``csrc/encoder_level.cu`` (``MEASUREMENT_BUILDS``), the tensor-core
encoder-level kernels:

- ``-DLEVEL_PHASES``: thread 0 of every block reads ``clock64()`` at each of
  the kernels' ``PHASE_MARK``s and adds the cycles since its previous
  reading to a device counter for that phase, and the reverse sweep counts
  the bytes of its weight-gradient slots it reads and writes in device
  memory. K9 runs at the three 512x1024 level shapes at batch 3 and K10 at
  batch 6, in bf16; one JSON line per kernel and level gives each phase's
  share of the summed block cycles (the readings perturb the kernels a
  little, so shares, not times) and K10's slot bytes.
- ``-DLEVEL_FWD_SMEM_PAD``: the forward asks for enough more shared memory
  that one block, not two, fits on an SM. K9 is timed at each level in
  turns with the library (library, padded, padded, library; each a median
  of CUDA-event times of one call queued behind a spin kernel, so the
  events hold the device's time, not the host's enqueue), which shows what
  the second resident block, overlapping one block's staging with the
  other's products, is worth.

``csrc/correlation.cu`` (``CORR_MEASUREMENT_BUILDS``), all six
correlation kernels, the forwards ``corr2d_fwd`` and ``corr1d_fwd`` and
the backwards ``corr2d_bwd_f1``, ``corr2d_bwd_f2``, ``corr1d_bwd_f1`` and
``corr1d_bwd_f2``, in bf16 at CerberusNet's five level shapes of a
512x1024 frame and at the DCV heads' level 3 at each dilation, the
forwards at batch 1 (served) and 2 (trained), the backwards at 2:

- ``-DCORR_PHASES``: every block synchronises at each ``PHASE_MARK`` and its
  thread 0 adds the cycles since its previous reading to a counter of that
  kernel and phase (staging, products and band, store; in the tensor-core
  2-D backwards, which keep the next window rows' copies in flight while
  the current one's products run, "stage" is the wait for copies the
  products did not hide, and "products" includes issuing the copies; the
  CUDA-core 1-D backwards store each output as soon as its sum is done,
  so their "products" include the stores and their "store" only a
  barrier); in the tensor-core forwards warp 0 also clocks each of its
  items (one band product) in two parts, the products up to the
  accumulators' arrival and the band. A second build adds ``-DCORR_SIMT``
  (below) to clock the CUDA-core kernels. After WARM_CALLS calls (the
  timed calls find the kernel's code and operands cached too), one JSON
  line per call gives each phase's share of the summed block cycles and
  warp 0's cycles per item, by design.
- ``-DCORR_SIMT``: bf16 runs the CUDA-core kernels that float32 runs. Each
  call is timed in turns with the library (library, CUDA cores, CUDA
  cores, library; each a median of device times as above), and the line
  gives both, the design each build counted in its turns and the largest
  difference of their outputs. A first line times an empty kernel the
  same way: the floor of these times.

The builds live in ``cerberusnet_torch/_build/``; nothing else loads them.
Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import statistics
import sys
import time

import torch

from cerberusnet_torch.ops import build
from cerberusnet_torch.ops.cuda import correlation as cc
from cerberusnet_torch.ops.cuda import encoder_level as cl

SOURCE = "encoder_level"
LEVELS = ((512, 1024, 3, 16), (256, 512, 16, 32), (128, 256, 32, 64))
BATCHES = {"fwd": 3, "bwd": 6}
# 48 KB more per forward block: each level's then exceeds half an SM
FWD_SMEM_PAD = 48 * 1024
MEASUREMENT_BUILDS = {"phases": ("LEVEL_PHASES",),
                      "one_block": (f"LEVEL_FWD_SMEM_PAD={FWD_SMEM_PAD}",)}
# the phases between one PHASE_MARK and the next, in the kernels' order;
# level 1 (im2col) stages in two steps (phase_names)
PHASES = {
    "fwd": ("stage", "y1", "y2", "y3"),
    "bwd": ("stage", "y1", "y2", "dk3", "g2", "dk2", "g1", "dk1, dx, db",
            "db sum", "slot write"),
}
N_COUNTERS = 2 * 16 + 2  # phase_cycles[2][16], slot_bytes[2]
TIMED_RUNS = 10

CORR_SOURCE = "correlation"
CORR_MEASUREMENT_BUILDS = {"phases": ("CORR_PHASES",),
                           "phases_cuda_cores": ("CORR_PHASES", "CORR_SIMT"),
                           "cuda_cores": ("CORR_SIMT",)}
CORR_PHASES = ("stage", "products and band", "store")
# the rows of corr_phase_cycles: (wrapper, design) of each kernel with
# phase marks
CORR_KERNELS = (("corr2d_fwd", "cuda_cores"), ("corr1d_fwd", "cuda_cores"),
                ("corr2d_fwd", "tc"), ("corr1d_fwd", "tc"),
                ("corr2d_bwd_f1", "cuda_cores"),
                ("corr2d_bwd_f2", "cuda_cores"),
                ("corr2d_bwd_f1", "tc"), ("corr2d_bwd_f2", "tc"),
                ("corr1d_bwd_f1", "cuda_cores"),
                ("corr1d_bwd_f2", "cuda_cores"),
                ("corr1d_bwd_f1", "tc"), ("corr1d_bwd_f2", "tc"))
# corr_item_cycles: the tensor-core forwards' rows (2, 3) of the four first
CORR_ITEM_ROWS = 4
# CerberusNet's pyramid levels of a 512x1024 frame: (level, channels); the
# flow head's d = 4, the disparity head's D = max(96 >> level, 4); the DCV
# heads at level 3 with d = D = 4
CORR_HW = (512, 1024)
CORR_LEVELS = ((6, 196), (5, 128), (4, 96), (3, 64), (2, 32))
CORR_DCV_DILATIONS = {"corr2d_fwd": (1, 2, 4, 8), "corr1d_fwd": (1, 2, 3),
                      "corr2d_bwd_f1": (1, 2, 4, 8),
                      "corr2d_bwd_f2": (1, 2, 4, 8),
                      "corr1d_bwd_f1": (1, 2, 3), "corr1d_bwd_f2": (1, 2, 3)}
# the forwards serve (batch 1) and train (batch 2); the backwards train
CORR_BATCHES = {"corr2d_fwd": (1, 2), "corr1d_fwd": (1, 2),
                "corr2d_bwd_f1": (2,), "corr2d_bwd_f2": (2,),
                "corr1d_bwd_f1": (2,), "corr1d_bwd_f2": (2,)}
WARM_CALLS = 3


def phase_names(kind: str, c: int) -> tuple:
    if c == 3:  # x's raw rows (and g3), then the im2col rows
        first = "stage x rows" if kind == "fwd" else "stage x rows, g3"
        return (first, "stage im2col rows") + PHASES[kind][1:]
    return PHASES[kind]


@contextlib.contextmanager
def launching(lib: ctypes.CDLL, source: str = SOURCE):
    """The wrappers launch ``lib`` in place of ``source``'s library inside."""
    key = (source, ())
    saved = build._loaded.get(key)
    build._loaded[key] = lib
    try:
        yield
    finally:
        if saved is None:
            build._loaded.pop(key)
        else:
            build._loaded[key] = saved


def level_inputs(b, h, w, c, f, gen):
    x = torch.randn((b, h, w, c), generator=gen, device="cuda")
    params = []
    for cin in (c, f, f):
        params.append(torch.randn((3, 3, cin, f), generator=gen,
                                  device="cuda") / (9 * cin) ** 0.5)
        params.append(0.1 * torch.randn((f,), generator=gen, device="cuda"))
    return x.bfloat16(), [p.bfloat16() for p in params]


def counters(lib) -> list:
    raw = (ctypes.c_ulonglong * N_COUNTERS)()
    err = lib.level_counters_read(raw)
    if err:
        raise RuntimeError(f"level_counters_read: cudaError_t {err}")
    return list(raw)


def spin_cycles_per_ms() -> float:
    """Calibrates torch.cuda._sleep, a spin kernel, in cycles per ms."""
    rate = 0.0
    for _ in range(2):  # the first call warms up
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda._sleep(10_000_000)
        end.record()
        torch.cuda.synchronize()
        rate = 10_000_000 / start.elapsed_time(end)
    return rate


def ms_per_call(fn, spin_rate: float) -> float:
    """Median of TIMED_RUNS device times of one call, each between two CUDA
    events behind a spin kernel twice as long as the host's enqueue."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    cycles = int(spin_rate * (2 * (time.perf_counter() - t0) * 1e3 + 0.05))
    torch.cuda.synchronize()
    pairs = []
    for _ in range(TIMED_RUNS):
        torch.cuda._sleep(cycles)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def corr_cases() -> list:
    """(wrapper, path, batch, level, (B, H, W, C), max_disp, dilation) of
    every call measured."""
    cases = []
    for name, dils in CORR_DCV_DILATIONS.items():
        for b in CORR_BATCHES[name]:
            for level, c in CORR_LEVELS:
                d = 4 if name.startswith("corr2d") else max(96 >> level, 4)
                shape = (b, CORR_HW[0] >> level, CORR_HW[1] >> level, c)
                cases.append((name, "cerberus", b, level, shape, d, 1))
            shape = (b, CORR_HW[0] >> 3, CORR_HW[1] >> 3, 64)
            cases += [(name, "dcv", b, 3, shape, 4, dil) for dil in dils]
    return cases


def corr_main(device: str, spin_rate: float):
    builds = {which: build.load(CORR_SOURCE, defines)
              for which, defines in CORR_MEASUREMENT_BUILDS.items()}
    lib = cc._library()
    gen = torch.Generator(device="cuda").manual_seed(0)
    # the floor of this timing: one launch of a spin kernel of no cycles
    print(json.dumps({"kernel": "empty", "device": device,
                      "ms": ms_per_call(lambda: torch.cuda._sleep(0),
                                        spin_rate)}), flush=True)
    for name, path, b, level, shape, d, dil in corr_cases():
        # a forward takes (f1, f2); a backward (g, f), g with the cost
        # volume's channels
        nk = (2 * d + 1) ** 2 if name.startswith("corr2d") else d + 1
        a_shape = (*shape[:3], nk) if "_bwd" in name else shape
        a, f = (torch.randn(s_, generator=gen, device="cuda").bfloat16()
                for s_ in (a_shape, shape))
        kernel = getattr(cc, name)

        def run():
            return kernel(a, f, d, dil)

        torch.cuda.synchronize()
        share, item = {}, {}
        # the clocks of each design: the tensor-core kernels in the phases
        # build, the CUDA-core ones in the phases build that runs them
        for which in ("phases", "phases_cuda_cores"):
            with launching(builds[which], CORR_SOURCE):
                for _ in range(WARM_CALLS):  # code and operands cached
                    run()
                torch.cuda.synchronize()
                builds[which].corr_counters_zero()
                run()
                torch.cuda.synchronize()
                raw = (ctypes.c_ulonglong * (3 * (len(CORR_KERNELS)
                                                  + CORR_ITEM_ROWS)))()
                err = builds[which].corr_counters_read(raw)
                if err:
                    raise RuntimeError(
                        f"corr_counters_read: cudaError_t {err}")
            for i, (kname, design) in enumerate(CORR_KERNELS):
                cycles = raw[3 * i:3 * i + 3]
                if kname == name and sum(cycles):
                    share[design] = {p: cycles[j] / sum(cycles)
                                     for j, p in enumerate(CORR_PHASES)}
                    share[design]["block_cycles"] = sum(cycles)
                at = 3 * (len(CORR_KERNELS) + i)
                products, band, items = (raw[at:at + 3]
                                         if i < CORR_ITEM_ROWS
                                         else (0, 0, 0))
                if kname == name and items:
                    item[design] = {"products": products / items,
                                    "band": band / items, "items": items}
        # each build counts the designs it launched in its own turns
        turns = {"library": lib, "cuda_cores": builds["cuda_cores"]}
        for turn_lib in turns.values():
            with launching(turn_lib, CORR_SOURCE):
                cc.reset_design_launches()
        outs, times, ran = {}, {"library": [], "cuda_cores": []}, {}
        for which in ("library", "cuda_cores", "cuda_cores", "library"):
            with launching(turns[which], CORR_SOURCE):
                outs[which] = run()
                times[which].append(ms_per_call(run, spin_rate))
                ran[which] = cc.launched_design()
        torch.cuda.synchronize()
        diff = (outs["library"].float() - outs["cuda_cores"].float()).abs()
        print(json.dumps({
            "kernel": name, "path": path, "batch": b, "level": level,
            "shape": list(shape), "max_disp": d, "dilation": dil,
            "device": device, "design": ran["library"],
            "cuda_cores_design": ran["cuda_cores"],
            "share": share, "ms": statistics.median(times["library"]),
            "cuda_cores_ms": statistics.median(times["cuda_cores"]),
            "item_cycles": item, "ms_runs": times,
            "max_abs_diff": diff.max().item()}),
            flush=True)
    cc.reset_launches()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--source", action="append",
                        choices=(SOURCE, CORR_SOURCE))
    sources = parser.parse_args(argv).source or (SOURCE, CORR_SOURCE)
    if not torch.cuda.is_available():
        print("level_phases: no CUDA device", file=sys.stderr)
        return 1
    device = torch.cuda.get_device_name(0)
    spin_rate = spin_cycles_per_ms()
    if SOURCE in sources:
        level_main(device, spin_rate)
    if CORR_SOURCE in sources:
        corr_main(device, spin_rate)
    return 0


def level_main(device: str, spin_rate: float):
    phases, one_block = (build.load(SOURCE, MEASUREMENT_BUILDS[which])
                         for which in ("phases", "one_block"))
    lib = cl._library()
    gen = torch.Generator(device="cuda").manual_seed(0)
    for level, (h, w, c, f) in enumerate(LEVELS, 1):
        for kind, b in BATCHES.items():
            x, params = level_inputs(b, h, w, c, f, gen)
            y3 = cl.level_fwd(x, *params)
            g = torch.randn(y3.shape, generator=gen, device="cuda").bfloat16()

            def run():
                if kind == "fwd":
                    return cl.level_fwd(x, *params)
                return cl.level_bwd(x, y3, g, *params, need_dx=level > 1)

            torch.cuda.synchronize()
            with launching(phases):
                phases.level_counters_zero()
                cl.reset_launches()
                run()
                torch.cuda.synchronize()
                partial = cl.encoder_level_bwd_partial_bytes
                counts = counters(phases)
            cycles = counts[:16] if kind == "fwd" else counts[16:32]
            names = phase_names(kind, c)
            total = sum(cycles)
            line = {"kernel": f"encoder_level_{kind}", "level": level,
                    "shape": [b, h, w, c, f], "device": device,
                    "share": {n: cycles[i] / total
                              for i, n in enumerate(names)},
                    "block_cycles": total}
            if kind == "bwd":
                line.update(kept_on_chip=(c, f) in cl.TC_KEPT,
                            partial_bytes=partial,
                            slot_bytes_read=counts[32],
                            slot_bytes_written=counts[33])
            else:
                times = {"library": [], "one_block": []}
                for which in ("library", "one_block", "one_block", "library"):
                    with launching(lib if which == "library" else one_block):
                        times[which].append(ms_per_call(run, spin_rate))
                line.update(
                    blocks_per_sm=lib.encoder_level_tc_blocks_per_sm(c, f, 0),
                    one_block_blocks_per_sm=(
                        one_block.encoder_level_tc_blocks_per_sm(c, f, 0)),
                    ms=statistics.median(times["library"]),
                    one_block_ms=statistics.median(times["one_block"]),
                    ms_runs=times)
            print(json.dumps(line), flush=True)
    cl.reset_launches()


if __name__ == "__main__":
    sys.exit(main())

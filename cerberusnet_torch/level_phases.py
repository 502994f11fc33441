"""Inside the tensor-core encoder-level kernels: phases, slot traffic and
residency.

    python3 -m cerberusnet_torch.level_phases

No kernel profiler runs on the H100's machine, so this builds
``csrc/encoder_level.cu`` twice more, with the source's measurement flags
(``MEASUREMENT_BUILDS``), and launches each build through the wrappers in
place of the library:

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

The builds live in ``cerberusnet_torch/_build/``; nothing else loads them.
Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import contextlib
import ctypes
import json
import statistics
import sys
import time

import torch

from cerberusnet_torch.ops import build
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


def phase_names(kind: str, c: int) -> tuple:
    if c == 3:  # x's raw rows (and g3), then the im2col rows
        first = "stage x rows" if kind == "fwd" else "stage x rows, g3"
        return (first, "stage im2col rows") + PHASES[kind][1:]
    return PHASES[kind]


@contextlib.contextmanager
def launching(lib: ctypes.CDLL):
    """The wrappers launch ``lib`` in place of the library inside."""
    key = (SOURCE, ())
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


def main() -> int:
    if not torch.cuda.is_available():
        print("level_phases: no CUDA device", file=sys.stderr)
        return 1
    phases, one_block = (build.load(SOURCE, MEASUREMENT_BUILDS[which])
                         for which in ("phases", "one_block"))
    lib = cl._library()
    gen = torch.Generator(device="cuda").manual_seed(0)
    device = torch.cuda.get_device_name(0)
    spin_rate = spin_cycles_per_ms()
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
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port (cerberusnet_torch) on one GPU and checks it.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failed check exits non-zero:
  env      the card (nvidia-smi name and power limit), torch and CUDA
  build    nvcc builds every kernel of the path from cerberusnet_torch/csrc
  kernels  each correlation kernel, forward and backward, against its plain
           PyTorch version on the card, at the five pyramid-level shapes of
           a 512x1024 frame (the forwards at batch 1, as served, and at
           batch 2, as trained; the backwards at batch 2), in bfloat16 and
           float32, plus one dilation-2 case; CUDA-event times of kernel
           and plain version beside the kernel's bound
  serve    the default-width CerberusNet through cerberusnet_torch.entry,
           bf16 at 512x1024, answering 3 seeded requests: output shapes,
           types and finiteness, the pyramids, and 5 + 5 kernel launches per
           request; then the same weights and inputs with the plain
           correlations in bf16 and in float32 (the yardstick), and the
           eager forward's CUDA-event time
  train    5 steps of configs/cerberus_synthetic.json through
           cerberusnet_torch.entry.train_entry (bf16, batch 2, 512x1024,
           constant learning rate): finite losses, 5 launches of each of
           the six kernels per step, every weight moved; then one step's
           gradients from the same weights and batch with the plain
           correlations in bf16 and in float32 (the yardstick), per module
           and per correlation input, and the same with each backward
           kernel, and then all four, returning zeros, which that
           comparison must catch; ms per train step with the kernels and
           with the plain correlations, in turns, and the peak device
           memory
Then a {"kernels": [...]} summary line (each kernel's numbers on the train
path, where all six run, with the serve path's beside them), the card's
nvidia-smi line and, last,
{"ok": true, "device": {...}}. Without a CUDA device it exits 1 and prints
no result.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

import torch

HW = (512, 1024)
ENCODER_CHANNELS = (16, 32, 64, 96, 128, 196)
LEVELS = (6, 5, 4, 3, 2)
FLOW_MAX_DISP = 4
MAX_DISP_FULL = 96
N_REQUESTS = 3
TRAIN_STEPS = 5
TRAIN_BATCH = 2
TIMED_RUNS = 30
# f32: only the summation order differs. bf16: both sides sum in f32 and
# round once, so they differ by at most one bf16 ulp (inputs unit-normal).
TOLERANCES = {torch.float32: (1e-5, 1e-6), torch.bfloat16: (2.0**-7, 1e-3)}
# Published peaks (NVIDIA data sheets, dense): device memory bytes/s and
# float32 FLOP/s on the CUDA cores, by the name nvidia-smi reports.
PEAKS = (
    ("H100 PCIe", 2.0e12, 51.2e12),
    ("H100 NVL", 3.9e12, 60.0e12),
    ("H100", 3.35e12, 67.0e12),  # SXM (HBM3)
)


def emit(obj):
    print(json.dumps(obj), flush=True)


def fail(phase, msg):
    emit({"phase": phase, "ok": False, "error": msg})
    sys.exit(1)


def card_peaks(name):
    for key, bw, flops in PEAKS:
        if key in name:
            return bw, flops
    return None, None


def sleep_cycles_per_ms():
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


def cuda_times(fn, runs=TIMED_RUNS, warmup=5, spin_rate=None):
    """Per-run CUDA-event times in ms after warmup: median, min, max.

    Without ``spin_rate`` the events bracket one eager call as a caller
    sees it, host gaps included. With it, a spin kernel twice as long as
    the host's enqueue of ``fn`` runs first, so the events bracket the
    device work of ``fn`` alone, back to back; that holds while ``fn``
    launches fewer kernels than the launch queue holds (about a thousand),
    so it is used for single ops, not for the whole forward."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    cycles = 0
    if spin_rate:
        t0 = time.perf_counter()
        fn()
        enqueue_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        cycles = int(spin_rate * (2 * enqueue_ms + 0.05))
    pairs = []
    for _ in range(runs):
        if cycles:
            torch.cuda._sleep(cycles)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    ms = [s.elapsed_time(e) for s, e in pairs]
    return {"median": statistics.median(ms), "min": min(ms), "max": max(ms),
            "runs": runs}


def level_max_disp(level):
    return max(MAX_DISP_FULL // 2**level, 4)


def in_frame(n, offsets):
    """Pixels of a line of n whose sample at each offset lies in the frame,
    summed over the offsets."""
    return sum(max(n - abs(o), 0) for o in offsets)


def corr2d_flops(b, h, w, c, d, dil):
    """Multiply-adds of the 2-D correlation with f2 in frame, times two:
    an out-of-frame product is zero by definition, so none is needed."""
    offsets = [o * dil for o in range(-d, d + 1)]
    return 2 * b * c * in_frame(h, offsets) * in_frame(w, offsets)


def corr1d_flops(b, h, w, c, d, dil):
    return 2 * b * h * c * in_frame(w, [k * dil for k in range(d + 1)])


def phase_env():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    card = smi.splitlines()[0].strip()
    name = torch.cuda.get_device_name(0)
    emit({"phase": "env", "ok": True, "nvidia_smi": card, "device": name,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0]})
    return card, name


def phase_build():
    from cerberusnet_torch.ops import build

    t0 = time.perf_counter()
    nvcc_seconds = build.build("correlation")
    build.load("correlation")
    emit({"phase": "build", "ok": True, "nvcc": build.find_nvcc(),
          "seconds": time.perf_counter() - t0, "nvcc_seconds": nvcc_seconds,
          "library": build.library_path("correlation").name})


def phase_kernels(peak_bw, peak_flops, spin_rate):
    from cerberusnet_torch.ops import correlation as corr
    from cerberusnet_torch.ops.cuda import correlation as cc

    def nk2d(d):
        return (2 * d + 1) ** 2

    def nk1d(d):
        return d + 1

    def flow_disp(level):
        return FLOW_MAX_DISP

    # name: (wrapper, plain version, max_disp of a level, cost-volume
    # channels, FLOPs, batches, is a backward). A forward takes (f1, f2)
    # and writes the cost volume; a backward takes (g, f), g the cost
    # volume's gradient, and writes one feature map's gradient. Both read
    # and write the same tensors' worth of bytes, and a backward does the
    # forward's in-frame multiply-adds. The forwards run at batch 1 when
    # served and at the train batch in a train step; the backwards only in
    # a train step.
    both = (1, TRAIN_BATCH)
    kernels = {
        "corr2d_fwd": (cc.corr2d_fwd, corr._correlation2d_plain, flow_disp,
                       nk2d, corr2d_flops, both, False),
        "corr1d_fwd": (cc.corr1d_fwd, corr._correlation1d_plain,
                       level_max_disp, nk1d, corr1d_flops, both, False),
        "corr2d_bwd_f1": (cc.corr2d_bwd_f1, corr._correlation2d_bwd_f1_plain,
                          flow_disp, nk2d, corr2d_flops, (TRAIN_BATCH,), True),
        "corr2d_bwd_f2": (cc.corr2d_bwd_f2, corr._correlation2d_bwd_f2_plain,
                          flow_disp, nk2d, corr2d_flops, (TRAIN_BATCH,), True),
        "corr1d_bwd_f1": (cc.corr1d_bwd_f1, corr._correlation1d_bwd_f1_plain,
                          level_max_disp, nk1d, corr1d_flops, (TRAIN_BATCH,),
                          True),
        "corr1d_bwd_f2": (cc.corr1d_bwd_f2, corr._correlation1d_bwd_f2_plain,
                          level_max_disp, nk1d, corr1d_flops, (TRAIN_BATCH,),
                          True),
    }
    gen = torch.Generator(device="cuda").manual_seed(0)
    checks = []
    for name, (kernel, plain, disp_of, nk_of, flops_of, batches,
               backward) in kernels.items():
        cases = [(batch, level, dt, 1) for batch in batches
                 for level in LEVELS
                 for dt in (torch.bfloat16, torch.float32)]
        cases.append((TRAIN_BATCH, 2, torch.bfloat16, 2))
        for batch, level, dt, dil in cases:
            shape = (batch, HW[0] >> level, HW[1] >> level,
                     ENCODER_CHANNELS[level - 1])
            d = disp_of(level)
            nk = nk_of(d)
            a_shape = (*shape[:3], nk) if backward else shape
            a = torch.randn(a_shape, generator=gen, device="cuda").to(dt)
            f = torch.randn(shape, generator=gen, device="cuda").to(dt)
            got = kernel(a, f, d, dil)
            torch.cuda.synchronize()
            want = plain(a, f, d, dil)
            rtol, atol = TOLERANCES[dt]
            diff = (got.float() - want.float()).abs()
            ok = bool((diff <= atol + rtol * want.float().abs()).all())

            def run_kernel():
                kernel(a, f, d, dil)

            def run_plain():
                plain(a, f, d, dil)

            k_t = cuda_times(run_kernel, spin_rate=spin_rate)
            k_eager = cuda_times(run_kernel)
            p_t = cuda_times(run_plain, runs=20, spin_rate=spin_rate)
            p_eager = cuda_times(run_plain, runs=20)
            b, h, w, c = shape
            nbytes = (2 * b * h * w * c + b * h * w * nk) * f.element_size()
            flops = flops_of(b, h, w, c, d, dil)
            bound_ms = max(nbytes / peak_bw, flops / peak_flops) * 1e3
            checks.append({
                "kernel": name, "batch": batch, "level": level,
                "shape": list(shape),
                "max_disp": d, "dilation": dil, "dtype": str(dt)[6:],
                "ok": ok, "max_abs_err": diff.max().item(),
                "rtol": rtol, "atol": atol, "ms": k_t["median"],
                "ms_min": k_t["min"], "ms_max": k_t["max"],
                "plain_ms": p_t["median"], "plain_ms_min": p_t["min"],
                "plain_ms_max": p_t["max"], "eager_ms": k_eager["median"],
                "eager_ms_min": k_eager["min"], "eager_ms_max": k_eager["max"],
                "plain_eager_ms": p_eager["median"],
                "bytes": nbytes, "flops": flops,
                "bound_ms": bound_ms,
                "bound_by": "bytes" if nbytes / peak_bw >= flops / peak_flops
                else "operations",
            })
    ok = all(c["ok"] for c in checks)
    emit({"phase": "kernels", "ok": ok, "runs": TIMED_RUNS,
          "timing": "ms: device time of one call (a spin kernel hides the "
                    "host's enqueue); eager_ms: one call as a caller sees it",
          "peak_bytes_per_s": peak_bw, "peak_f32_flops_per_s": peak_flops,
          "checks": checks})
    if not ok:
        sys.exit(1)
    return checks


def rel_l2(a, ref):
    return ((a.float() - ref).norm() / ref.norm().clamp_min(1e-12)).item()


def phase_serve():
    from cerberusnet_torch.entry import entry, make_frames
    from cerberusnet_torch.ops.cuda import correlation as cc

    forward, _ = entry()
    plain_bf16, _ = entry(corr_impl="plain")
    plain_f32, _ = entry(dtype=torch.float32, corr_impl="plain")
    requests = [make_frames(seed, HW) for seed in range(1, N_REQUESTS + 1)]

    errors = []
    want_rise = {k: len(LEVELS) if k.endswith("_fwd") else 0
                 for k in cc.KERNELS}
    cc.reset_launches()
    answers = []
    for i, req in enumerate(requests):
        before = cc.launches()
        out = forward(*req)
        torch.cuda.synchronize()
        rise = {k: v - before[k] for k, v in cc.launches().items()}
        if rise != want_rise:
            errors.append(f"request {i}: kernel launches rose by {rise}")
        answers.append(out)
    launches = cc.launches()

    h, w = HW
    want = {"seg_logits": (1, h, w, 19), "flow": (1, h, w, 2),
            "disp": (1, h, w, 1)}
    for i, out in enumerate(answers):
        for key, shape in want.items():
            v = out[key]
            if tuple(v.shape) != shape or v.dtype != torch.float32:
                errors.append(f"request {i}: {key} {tuple(v.shape)} {v.dtype}")
            elif not bool(torch.isfinite(v).all()):
                errors.append(f"request {i}: {key} not finite")
            elif v.abs().max().item() <= 0:
                errors.append(f"request {i}: {key} all zero")
        for key, ch in (("flow_pyramid", 2), ("disp_pyramid", 1)):
            got = {l: tuple(v.shape) for l, v in out[key].items()}
            need = {l: (1, h >> l, w >> l, ch) for l in LEVELS}
            if got != need:
                errors.append(f"request {i}: {key} {got}")

    distances = []
    for i, req in enumerate(requests):
        ref = plain_f32(*req)
        base = plain_bf16(*req)
        for key in want:
            d_kernel = rel_l2(answers[i][key], ref[key])
            d_plain = rel_l2(base[key], ref[key])
            limit = 1.5 * d_plain + 1e-3
            distances.append({"request": i, "head": key,
                              "kernel_bf16_vs_f32": d_kernel,
                              "plain_bf16_vs_f32": d_plain, "limit": limit})
            if not d_kernel <= limit:
                errors.append(f"request {i}: {key} rel L2 {d_kernel} > {limit}")

    # eager forward time, kernel path and plain path in turns on one card
    req = requests[0]
    paths = {"kernel": forward, "plain": plain_bf16}
    times = {"plain": [], "kernel": []}
    for which in ("plain", "kernel", "kernel", "plain"):
        times[which].append(
            cuda_times(lambda: paths[which](*req), runs=20, warmup=3))
    fwd = {}
    for which, parts in times.items():
        med = statistics.median([p["median"] for p in parts])
        fwd[which] = {
            "ms_per_frame": med, "frames_per_s": 1e3 / med,
            "ms_min": min(p["min"] for p in parts),
            "ms_max": max(p["max"] for p in parts),
            "block_medians": [p["median"] for p in parts],
            "runs": sum(p["runs"] for p in parts)}
    peak_mem = torch.cuda.max_memory_allocated() / 2**30
    ok = not errors
    emit({"phase": "serve", "ok": ok, "hw": list(HW), "dtype": "bfloat16",
          "requests": N_REQUESTS, "launches": launches,
          "launches_per_request": {k: v / N_REQUESTS
                                   for k, v in launches.items()},
          "distances": distances, "forward": fwd,
          "max_memory_allocated_gib": peak_mem, "errors": errors})
    if not ok:
        sys.exit(1)
    return launches


MODULES = ("encoder", "flow", "disparity", "segmentation")
BACKWARDS = ("corr2d_bwd_f1", "corr2d_bwd_f2", "corr1d_bwd_f1",
             "corr1d_bwd_f2")


def grads_and_taps(trainer, batch):
    """One step's gradients (``trainer.loss_and_grads``) and the gradient
    each correlation call hands each of its inputs, as {"corr2d level 6
    df1": tensor, ...}. An input goes through an identity view whose hook
    reads its gradient, so the hook sees the correlation's share alone:
    within a module's whole gradient that share is too small to show."""
    from cerberusnet_torch.models.disparity import DisparityDecoder
    from cerberusnet_torch.models.flow import FlowDecoder

    taps = {}

    def tapped(kind, correlate):
        def call(self, level, f1, f2):
            views = []
            for which, f in (("df1", f1), ("df2", f2)):
                v = f.view_as(f)
                key = f"{kind} level {level} {which}"
                v.register_hook(
                    lambda g, key=key: taps.__setitem__(key, g.float()))
                views.append(v)
            return correlate(self, level, *views)
        return call

    saved = {FlowDecoder: FlowDecoder.correlate,
             DisparityDecoder: DisparityDecoder.correlate}
    FlowDecoder.correlate = tapped("corr2d", saved[FlowDecoder])
    DisparityDecoder.correlate = tapped("corr1d", saved[DisparityDecoder])
    try:
        _, grads = trainer.loss_and_grads(batch)
    finally:
        for cls, fn in saved.items():
            cls.correlate = fn
    return grads, taps


def module_rel_l2(grads, ref):
    """Relative L2 distance of each module's gradients (all its parameters
    as one vector) to the reference's."""
    out = {}
    for mod in MODULES:
        names = [n for n in ref if n.split(".")[0] == mod]
        a = torch.cat([grads[n].flatten() for n in names])
        b = torch.cat([ref[n].flatten() for n in names])
        out[mod] = rel_l2(a, b)
    return out


def phase_train():
    from cerberusnet_torch.entry import train_entry
    from cerberusnet_torch.ops.cuda import correlation as cc

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    constant = {"schedule": "constant"}
    trainer, batches = train_entry(batch_size=TRAIN_BATCH,
                                   n_batches=TRAIN_STEPS, optim=constant)
    setup_s = time.perf_counter() - t0
    errors = []
    before = {n: m.clone() for n, m in trainer.masters.items()}
    steps = []
    cc.reset_launches()
    for i, batch in enumerate(batches):
        prev = cc.launches()
        comps = trainer.train_step(batch)
        torch.cuda.synchronize()
        rise = {k: v - prev[k] for k, v in cc.launches().items()}
        if set(rise.values()) != {len(LEVELS)}:
            errors.append(f"step {i}: kernel launches rose by {rise}")
        vals = {k: v.item() for k, v in comps.items()}
        if not all(map(math.isfinite, vals.values())):
            errors.append(f"step {i}: loss components {vals}")
        steps.append(vals)
    launches = cc.launches()
    moved = sum(not torch.equal(m, before[n])
                for n, m in trainer.masters.items())
    if moved != len(before):
        errors.append(f"{len(before) - moved} of {len(before)} weights did "
                      f"not move in {TRAIN_STEPS} steps")

    # one step's gradients from the same weights and batch: kernels (bf16)
    # against the plain correlations in bf16 and in float32 (the yardstick)
    plain16, _ = train_entry(batch_size=TRAIN_BATCH, n_batches=0,
                             corr_impl="plain", optim=constant)
    plain32, _ = train_entry(batch_size=TRAIN_BATCH, n_batches=0,
                             corr_impl="plain", optim=constant,
                             model={"dtype": "float32"})
    batch = batches[0]
    plain16.load_masters(trainer.masters)
    plain32.load_masters(trainer.masters)
    # per module, and per correlation input (taps)
    grads, taps = {}, {}
    for which, tr in (("kernel", trainer), ("plain_bf16", plain16),
                      ("plain_f32", plain32)):
        grads[which], taps[which] = grads_and_taps(tr, batch)
        torch.cuda.synchronize()
        if len(taps[which]) != 2 * 2 * len(LEVELS):
            fail("train", f"{which}: {len(taps[which])} correlation input "
                          f"gradients, not {4 * len(LEVELS)}")
    ref, ref_taps = grads["plain_f32"], taps["plain_f32"]

    def distances_of(g, t):
        return {**module_rel_l2(g, ref),
                **{k: rel_l2(t[k], ref_taps[k]) for k in ref_taps}}

    d_kernel = distances_of(grads["kernel"], taps["kernel"])
    d_plain = distances_of(grads["plain_bf16"], taps["plain_bf16"])
    limits = {k: 1.5 * v + 1e-3 for k, v in d_plain.items()}
    distances = [{"of": k, "kernel_bf16_vs_f32": d_kernel[k],
                  "plain_bf16_vs_f32": d_plain[k], "limit": limits[k]}
                 for k in limits]
    errors += [f"{k} gradient rel L2 {d_kernel[k]} > {limits[k]}"
               for k in limits if not d_kernel[k] <= limits[k]]

    # controls: the same step with backward kernels that return zeros, one
    # at a time and all four (a cost volume without gradient); the
    # comparison above must put each beyond a limit
    controls = []
    for dropped in [(k,) for k in BACKWARDS] + [BACKWARDS]:
        saved = {k: getattr(cc, k) for k in dropped}
        for k in dropped:
            setattr(cc, k, lambda g, f, d, dil: torch.zeros_like(f))
        try:
            faulty, faulty_taps = grads_and_taps(trainer, batch)
        finally:
            for k, fn in saved.items():
                setattr(cc, k, fn)
        dist = distances_of(faulty, faulty_taps)
        caught = [k for k in limits if not dist[k] <= limits[k]]
        controls.append({
            "zeroed": list(dropped), "caught_by": caught,
            "module_rel_l2": {m: dist[m] for m in MODULES},
            "module_limit": {m: limits[m] for m in MODULES},
            "module_rel_l2_to_kernel_path": module_rel_l2(faulty,
                                                          grads["kernel"])})
        if not caught:
            errors.append(f"zeroing {dropped} stays within every limit: "
                          f"{dist}")
    del grads, taps, faulty, faulty_taps, plain32

    # ms per train step, kernel path and plain path in turns on one card
    paths = {"kernel": trainer, "plain": plain16}
    times = {"plain": [], "kernel": []}
    for which in ("plain", "kernel", "kernel", "plain"):
        tr = paths[which]
        times[which].append(cuda_times(lambda: tr.train_step(batch),
                                       runs=10, warmup=2))
    step = {}
    for which, parts in times.items():
        med = statistics.median([p["median"] for p in parts])
        step[which] = {
            "ms_per_step": med, "frames_per_s": TRAIN_BATCH * 1e3 / med,
            "ms_min": min(p["min"] for p in parts),
            "ms_max": max(p["max"] for p in parts),
            "block_medians": [p["median"] for p in parts],
            "runs": sum(p["runs"] for p in parts)}
    peak_mem = torch.cuda.max_memory_allocated() / 2**30
    ok = not errors
    emit({"phase": "train", "ok": ok, "config": "configs/cerberus_synthetic.json",
          "hw": list(HW), "batch": TRAIN_BATCH, "dtype": "bfloat16",
          "steps": steps, "launches": launches,
          "launches_per_step": {k: v / TRAIN_STEPS
                                for k, v in launches.items()},
          "weights_moved": moved, "weights": len(before),
          "setup_s": setup_s, "distances": distances, "controls": controls,
          "train_step": step,
          "timing": "CUDA events around one train_step(batch) call, host "
                    "batch in, preprocessing and optimizer included",
          "max_memory_allocated_gib": peak_mem, "errors": errors})
    if not ok:
        sys.exit(1)
    return launches


REPLACES = {
    "corr2d_fwd": "cerberusnet_tpu/ops/pallas/correlation.py:86 "
                  "(_corr2d_fwd_kernel, pallas_call at :153)",
    "corr1d_fwd": "cerberusnet_tpu/ops/pallas/correlation.py:234 "
                  "(_corr1d_fwd_kernel, pallas_call at :281)",
    "corr2d_bwd_f1": "cerberusnet_tpu/ops/pallas/correlation.py:102 "
                     "(_corr2d_bwd_f1_kernel, pallas_call at :197)",
    "corr2d_bwd_f2": "cerberusnet_tpu/ops/pallas/correlation.py:122 "
                     "(_corr2d_bwd_f2_kernel, pallas_call at :214)",
    "corr1d_bwd_f1": "cerberusnet_tpu/ops/pallas/correlation.py:243 "
                     "(_corr1d_bwd_f1_kernel, pallas_call at :323)",
    "corr1d_bwd_f2": "cerberusnet_tpu/ops/pallas/correlation.py:255 "
                     "(_corr1d_bwd_f2_kernel, pallas_call at :335)",
}


def path_numbers(checks, name, batch, launches):
    """A kernel's numbers on one path: its five calls there in bf16 at
    that path's batch, summed, with the path's launch count and the
    per-call rows under "shapes"."""
    rows = [c for c in checks if c["kernel"] == name and c["batch"] == batch
            and c["dtype"] == "bfloat16" and c["dilation"] == 1]
    bound = sum(r["bound_ms"] for r in rows)
    by_bytes = sum(r["bound_ms"] for r in rows if r["bound_by"] == "bytes")
    return {
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": sum(r["ms"] for r in rows),
        "plain_ms": sum(r["plain_ms"] for r in rows),
        "bound_ms": bound,
        "bound_by": "bytes" if by_bytes >= bound / 2 else "operations",
        "batch": batch,
        "eager_ms": sum(r["eager_ms"] for r in rows),
        "plain_eager_ms": sum(r["plain_eager_ms"] for r in rows),
        "shapes": [{k: r[k] for k in (
            "level", "shape", "max_disp", "ms", "ms_min", "ms_max",
            "eager_ms", "plain_ms", "plain_eager_ms", "bound_ms",
            "bound_by", "max_abs_err")} for r in rows],
    }


def summary(checks, serve_launches, train_launches):
    """One entry per kernel. Its numbers are the train path's (batch 2),
    where all six kernels run: launches from that path's run, times and
    bounds from its shapes. A forward's serve-path numbers (batch 1) stand
    under "paths" beside them."""
    entries = []
    for name, replaces in REPLACES.items():
        train = path_numbers(checks, name, TRAIN_BATCH, train_launches[name])
        paths = {"train": {k: v for k, v in train.items() if k != "shapes"}}
        if serve_launches[name]:
            serve = path_numbers(checks, name, 1, serve_launches[name])
            paths["serve"] = {k: v for k, v in serve.items() if k != "shapes"}
        entries.append({
            "name": name, "route": "cuda",
            "source": "cerberusnet_torch/csrc/correlation.cu",
            "replaces": replaces, "library_ms": None, **train,
            "paths": paths})
    emit({"kernels": entries})


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    import cerberusnet_torch  # noqa: F401  fails where the port is absent

    # f32 results are compared on the card: keep cuDNN and cuBLAS in full
    # f32 (no TF32). bf16 runs are unaffected.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    card, name = phase_env()
    peak_bw, peak_flops = card_peaks(name)
    if peak_bw is None:
        fail("env", f"no published peaks known for {name!r}")
    phase_build()
    spin_rate = sleep_cycles_per_ms()
    checks = phase_kernels(peak_bw, peak_flops, spin_rate)
    serve_launches = phase_serve()
    train_launches = phase_train()
    summary(checks, serve_launches, train_launches)
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

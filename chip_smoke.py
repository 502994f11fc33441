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
           float32, plus one dilation-2 case; and at the DCV heads' level-3
           shape (B, 64, 128, 64) with d = D = 4, the 2-D kernels at
           dilations 1, 2, 4, 8 and the 1-D ones at 1, 2, 3, at the same
           batches; CUDA-event times of kernel and plain version beside the
           kernel's bound
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
  serve_dcv  the default-width CerberusDCV through
           cerberusnet_torch.entry.entry(variant="cerberus_dcv"), as serve:
           4 + 3 kernel launches per request (the 2-D op at dilations
           1, 2, 4, 8 and the 1-D op at 1, 2, 3, at level 3), one-level
           pyramids
  train_dcv  5 steps of configs/cerberus_dcv.json (uncertainty weighting)
           as train: 4 launches of each 2-D kernel and 3 of each 1-D kernel
           per step, every weight and the three log-variances moved, the
           gradients of the seven correlation calls' inputs against the
           yardstick, and one control with all four backward kernels zeroed
Then a {"kernels": [...]} summary line (each kernel's numbers on the train
path, where all six run, with the serve path's beside them and the DCV
paths' under "dcv"), the card's nvidia-smi line and, last,
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
# the DCV heads: one level, d = D = 4, the dilations of CerberusDCV
DCV_LEVEL = 3
DCV_MAX_DISP = 4
DCV_FLOW_DILATIONS = (1, 2, 4, 8)
DCV_DISP_DILATIONS = (1, 2, 3)
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
    # channels, FLOPs, batches, is a backward, the dilations of the DCV
    # head that calls it). A forward takes (f1, f2) and writes the cost
    # volume; a backward takes (g, f), g the cost volume's gradient, and
    # writes one feature map's gradient. Both read and write the same
    # tensors' worth of bytes, and a backward does the forward's in-frame
    # multiply-adds. The forwards run at batch 1 when served and at the
    # train batch in a train step; the backwards only in a train step.
    both = (1, TRAIN_BATCH)
    train = (TRAIN_BATCH,)
    flow_dils, disp_dils = DCV_FLOW_DILATIONS, DCV_DISP_DILATIONS
    kernels = {
        "corr2d_fwd": (cc.corr2d_fwd, corr._correlation2d_plain, flow_disp,
                       nk2d, corr2d_flops, both, False, flow_dils),
        "corr1d_fwd": (cc.corr1d_fwd, corr._correlation1d_plain,
                       level_max_disp, nk1d, corr1d_flops, both, False,
                       disp_dils),
        "corr2d_bwd_f1": (cc.corr2d_bwd_f1, corr._correlation2d_bwd_f1_plain,
                          flow_disp, nk2d, corr2d_flops, train, True,
                          flow_dils),
        "corr2d_bwd_f2": (cc.corr2d_bwd_f2, corr._correlation2d_bwd_f2_plain,
                          flow_disp, nk2d, corr2d_flops, train, True,
                          flow_dils),
        "corr1d_bwd_f1": (cc.corr1d_bwd_f1, corr._correlation1d_bwd_f1_plain,
                          level_max_disp, nk1d, corr1d_flops, train, True,
                          disp_dils),
        "corr1d_bwd_f2": (cc.corr1d_bwd_f2, corr._correlation1d_bwd_f2_plain,
                          level_max_disp, nk1d, corr1d_flops, train, True,
                          disp_dils),
    }
    gen = torch.Generator(device="cuda").manual_seed(0)
    checks = []
    dtypes = (torch.bfloat16, torch.float32)
    for name, (kernel, plain, disp_of, nk_of, flops_of, batches,
               backward, dcv_dilations) in kernels.items():
        # (path, batch, level, dtype, dilation, max_disp): CerberusNet's
        # levels, one dilation-2 case, and the DCV head's calls
        cases = [("cerberus", batch, level, dt, 1, disp_of(level))
                 for batch in batches for level in LEVELS for dt in dtypes]
        cases.append(("extra", TRAIN_BATCH, 2, torch.bfloat16, 2, disp_of(2)))
        cases += [("dcv", batch, DCV_LEVEL, dt, dil, DCV_MAX_DISP)
                  for batch in batches for dil in dcv_dilations
                  for dt in dtypes]
        for path, batch, level, dt, dil, d in cases:
            shape = (batch, HW[0] >> level, HW[1] >> level,
                     ENCODER_CHANNELS[level - 1])
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
                "kernel": name, "path": path, "batch": batch, "level": level,
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


# phase: (entry variant, pyramid levels, forward kernel launches per request)
SERVE = {
    "serve": ("cerberus", LEVELS,
              {"corr2d_fwd": len(LEVELS), "corr1d_fwd": len(LEVELS)}),
    "serve_dcv": ("cerberus_dcv", (DCV_LEVEL,),
                  {"corr2d_fwd": len(DCV_FLOW_DILATIONS),
                   "corr1d_fwd": len(DCV_DISP_DILATIONS)}),
}


def phase_serve(phase):
    from cerberusnet_torch.entry import entry, make_frames
    from cerberusnet_torch.ops.cuda import correlation as cc

    variant, levels, fwd_launches = SERVE[phase]
    torch.cuda.reset_peak_memory_stats()
    forward, _ = entry(variant=variant)
    plain_bf16, _ = entry(variant=variant, corr_impl="plain")
    plain_f32, _ = entry(variant=variant, dtype=torch.float32,
                         corr_impl="plain")
    requests = [make_frames(seed, HW) for seed in range(1, N_REQUESTS + 1)]

    errors = []
    want_rise = {k: fwd_launches.get(k, 0) for k in cc.KERNELS}
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
            need = {l: (1, h >> l, w >> l, ch) for l in levels}
            if got != need:
                errors.append(f"request {i}: {key} {got}")
            elif not all(bool(torch.isfinite(v).all())
                         for v in out[key].values()):
                errors.append(f"request {i}: {key} not finite")

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
    emit({"phase": phase, "ok": ok, "variant": variant, "hw": list(HW),
          "dtype": "bfloat16", "requests": N_REQUESTS, "launches": launches,
          "launches_per_request": {k: v / N_REQUESTS
                                   for k, v in launches.items()},
          "distances": distances, "forward": fwd,
          "max_memory_allocated_gib": peak_mem, "errors": errors})
    if not ok:
        sys.exit(1)
    return launches


BACKWARDS = ("corr2d_bwd_f1", "corr2d_bwd_f2", "corr1d_bwd_f1",
             "corr1d_bwd_f2")
# phase: (config, the model's correlation calls per step (2-D, 1-D), the
# zeroed-backward controls)
TRAIN = {
    "train": ("configs/cerberus_synthetic.json", (len(LEVELS), len(LEVELS)),
              [(k,) for k in BACKWARDS] + [BACKWARDS]),
    "train_dcv": ("configs/cerberus_dcv.json",
                  (len(DCV_FLOW_DILATIONS), len(DCV_DISP_DILATIONS)),
                  [BACKWARDS]),
}


def grads_and_taps(trainer, batch):
    """One step's gradients (``trainer.loss_and_grads``) and the gradient
    each correlation call hands each of its inputs, as {"corr2d level 6
    df1": tensor, ...} (CerberusNet's decoders, by level) or {"corr2d
    dilation 8 df1": tensor, ...} (the DCV decoders, by dilation). An
    input goes through an identity view whose hook reads its gradient, so
    the hook sees the correlation's share alone: within a module's whole
    gradient that share is too small to show."""
    from cerberusnet_torch.models.dcv_flow import (
        DCVFlowDecoder,
        DCVStereoDecoder,
    )
    from cerberusnet_torch.models.disparity import DisparityDecoder
    from cerberusnet_torch.models.flow import FlowDecoder

    taps = {}

    def tapped(kind, correlate):
        def call(self, arg, f1, f2):
            views = []
            for which, f in (("df1", f1), ("df2", f2)):
                v = f.view_as(f)
                key = f"{kind} {arg} {which}"
                v.register_hook(
                    lambda g, key=key: taps.__setitem__(key, g.float()))
                views.append(v)
            return correlate(self, arg, *views)
        return call

    kinds = {FlowDecoder: "corr2d level", DisparityDecoder: "corr1d level",
             DCVFlowDecoder: "corr2d dilation",
             DCVStereoDecoder: "corr1d dilation"}
    saved = {cls: cls.correlate for cls in kinds}
    for cls, kind in kinds.items():
        cls.correlate = tapped(kind, saved[cls])
    try:
        _, grads = trainer.loss_and_grads(batch)
    finally:
        for cls, fn in saved.items():
            cls.correlate = fn
    return grads, taps


def module_rel_l2(grads, ref):
    """Relative L2 distance of each module's gradients (all its parameters
    as one vector) to the reference's; the log-variances of uncertainty
    weighting count as one module."""
    out = {}
    for mod in sorted({n.split(".")[0] for n in ref}):
        names = [n for n in ref if n.split(".")[0] == mod]
        a = torch.cat([grads[n].flatten() for n in names])
        b = torch.cat([ref[n].flatten() for n in names])
        out[mod] = rel_l2(a, b)
    return out


def phase_train(phase):
    from cerberusnet_torch.entry import train_entry
    from cerberusnet_torch.ops.cuda import correlation as cc
    from cerberusnet_torch.train.trainer import UNCERTAINTY

    config, (n2d, n1d), control_sets = TRAIN[phase]
    want_rise = {k: n2d if k.startswith("corr2d") else n1d
                 for k in cc.KERNELS}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    constant = {"schedule": "constant"}
    trainer, batches = train_entry(config, batch_size=TRAIN_BATCH,
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
        if rise != want_rise:
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
    log_vars = {n: m.item() for n, m in trainer.masters.items()
                if n.startswith(UNCERTAINTY)}
    if trainer.config.loss.uncertainty_weighting and not (
            len(log_vars) == 3 and all(v != 0 for v in log_vars.values())):
        errors.append(f"the log-variances did not all move: {log_vars}")

    # one step's gradients from the same weights and batch: kernels (bf16)
    # against the plain correlations in bf16 and in float32 (the yardstick)
    plain16, _ = train_entry(config, batch_size=TRAIN_BATCH, n_batches=0,
                             corr_impl="plain", optim=constant)
    plain32, _ = train_entry(config, batch_size=TRAIN_BATCH, n_batches=0,
                             corr_impl="plain", optim=constant,
                             model={"dtype": "float32"})
    batch = batches[0]
    plain16.load_masters(trainer.masters)
    plain32.load_masters(trainer.masters)
    # per module, and per correlation input (taps)
    grads, taps = {}, {}
    n_taps = 2 * (n2d + n1d)
    for which, tr in (("kernel", trainer), ("plain_bf16", plain16),
                      ("plain_f32", plain32)):
        grads[which], taps[which] = grads_and_taps(tr, batch)
        torch.cuda.synchronize()
        if len(taps[which]) != n_taps:
            fail(phase, f"{which}: {len(taps[which])} correlation input "
                        f"gradients, not {n_taps}")
    ref, ref_taps = grads["plain_f32"], taps["plain_f32"]

    def distances_of(g, t):
        return {**module_rel_l2(g, ref),
                **{k: rel_l2(t[k], ref_taps[k]) for k in ref_taps}}

    d_kernel = distances_of(grads["kernel"], taps["kernel"])
    modules = [k for k in d_kernel if k not in ref_taps]
    d_plain = distances_of(grads["plain_bf16"], taps["plain_bf16"])
    limits = {k: 1.5 * v + 1e-3 for k, v in d_plain.items()}
    distances = [{"of": k, "kernel_bf16_vs_f32": d_kernel[k],
                  "plain_bf16_vs_f32": d_plain[k], "limit": limits[k]}
                 for k in limits]
    errors += [f"{k} gradient rel L2 {d_kernel[k]} > {limits[k]}"
               for k in limits if not d_kernel[k] <= limits[k]]

    # controls: the same step with backward kernels that return zeros (one
    # at a time and all four, or all four alone: a cost volume without
    # gradient); the comparison above must put each beyond a limit
    controls = []
    for dropped in control_sets:
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
            "module_rel_l2": {m: dist[m] for m in modules},
            "module_limit": {m: limits[m] for m in modules},
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
    emit({"phase": phase, "ok": ok, "config": config,
          "hw": list(HW), "batch": TRAIN_BATCH, "dtype": "bfloat16",
          "steps": steps, "launches": launches,
          "launches_per_step": {k: v / TRAIN_STEPS
                                for k, v in launches.items()},
          "weights_moved": moved, "weights": len(before),
          "log_variances": log_vars,
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
# the TPU kernels of the DCV heads, which the forwards also replace at
# dilation; the reference differentiates the DCV path without a kernel
DCV_REPLACES = {
    "corr2d_fwd": "cerberusnet_tpu/ops/pallas/correlation.py:369 "
                  "(_corr2d_wl_kernel, pallas_call at :420)",
    "corr1d_fwd": "cerberusnet_tpu/ops/pallas/correlation.py:385 "
                  "(_corr1d_wl_kernel, pallas_call at :453)",
}


def path_numbers(checks, name, path, batch, launches):
    """A kernel's numbers on one path: its calls there ("cerberus": the
    five levels; "dcv": the dilations) in bf16 at that path's batch,
    summed, with the path's launch count and the per-call rows under
    "shapes"."""
    rows = [c for c in checks if c["kernel"] == name and c["path"] == path
            and c["batch"] == batch and c["dtype"] == "bfloat16"]
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
            "level", "shape", "max_disp", "dilation", "ms", "ms_min",
            "ms_max", "eager_ms", "plain_ms", "plain_eager_ms", "bound_ms",
            "bound_by", "max_abs_err")} for r in rows],
    }


def summary(checks, launches):
    """One entry per kernel. Its numbers are the CerberusNet train path's
    (batch 2), where all six kernels run: launches from that path's run,
    times and bounds from its shapes. A forward's serve-path numbers
    (batch 1) stand under "paths" beside them, and each kernel's numbers
    on the DCV paths, by dilation, under "dcv"."""
    entries = []
    for name, replaces in REPLACES.items():
        train = path_numbers(checks, name, "cerberus", TRAIN_BATCH,
                             launches["train"][name])
        paths = {"train": {k: v for k, v in train.items() if k != "shapes"}}
        dcv = {"train_dcv": path_numbers(checks, name, "dcv", TRAIN_BATCH,
                                         launches["train_dcv"][name])}
        if launches["serve"][name]:
            serve = path_numbers(checks, name, "cerberus", 1,
                                 launches["serve"][name])
            paths["serve"] = {k: v for k, v in serve.items() if k != "shapes"}
            dcv["serve_dcv"] = path_numbers(checks, name, "dcv", 1,
                                            launches["serve_dcv"][name])
        dils = (DCV_FLOW_DILATIONS if name.startswith("corr2d")
                else DCV_DISP_DILATIONS)
        entries.append({
            "name": name, "route": "cuda",
            "source": "cerberusnet_torch/csrc/correlation.cu",
            "replaces": replaces, "library_ms": None, **train,
            "paths": paths,
            "dcv": {"replaces": DCV_REPLACES.get(name),
                    "dilations": list(dils), "paths": dcv}})
    emit({"kernels": entries})


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    import cerberusnet_torch  # noqa: F401  fails where the port is absent

    t0 = time.perf_counter()
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
    launches = {}
    for phase in ("serve", "train", "serve_dcv", "train_dcv"):
        run = phase_serve if phase in SERVE else phase_train
        launches[phase] = run(phase)
    summary(checks, launches)
    emit({"phase": "done", "ok": True,
          "seconds": time.perf_counter() - t0})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

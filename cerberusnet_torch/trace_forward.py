"""Where the time of one forward goes on the GPU.

    python3 -m cerberusnet_torch.trace_forward [--corr-impl plain]

Runs the default-width CerberusNet (bf16, 512x1024, batch 1, through
``entry``) under ``torch.profiler`` for 5 forwards after warmup and prints
one JSON line: wall ms per forward, the device's kernel time per forward by
category (convolutions, the correlation kernels, warp gathers, bilinear
resizes, concatenations, pads, other elementwise), the device's idle share,
the number of kernel launches per forward, and the top kernels. A kernel's
category comes from a substring of its name, so each category also lists
the names it took, where a misfiled kernel shows. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

RUNS = 5
# first match wins; kernel names are lower-cased before matching
CATEGORIES = (
    ("correlation", ("corr2d_fwd", "corr1d_fwd")),
    # nvjet: cuBLAS GEMMs; the model calls no matmul, so these run its
    # convolutions
    ("convolution", ("conv", "xmma", "cudnn", "implicit", "gemm", "cutlass",
                     "sm90", "winograd", "fft", "nvjet")),
    ("warp_gather", ("gather",)),
    ("resize", ("upsample", "interpolate")),
    ("concat", ("cat",)),
    ("pad", ("pad",)),
)


def category(name: str) -> str:
    low = name.lower()
    for cat, keys in CATEGORIES:
        if any(k in low for k in keys):
            return cat
    return "other"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--corr-impl", choices=["plain"], default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("trace_forward: no CUDA device", file=sys.stderr)
        return 1
    from cerberusnet_torch.entry import entry

    # as chip_smoke.py times the forward: the f32 classifier without TF32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    forward, imgs = entry(corr_impl=args.corr_impl)
    for _ in range(3):
        forward(*imgs)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(RUNS):
            forward(*imgs)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / RUNS

    kernels = {}
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        k = kernels.setdefault(evt.name, [0, 0.0])
        k[0] += 1
        k[1] += evt.device_time_total / 1e3  # us -> ms
    by_cat, launches = {}, 0
    for name, (count, ms) in kernels.items():
        cat = by_cat.setdefault(category(name), [0, 0.0, []])
        cat[0] += count
        cat[1] += ms
        cat[2].append(name[:80])
        launches += count
    busy = sum(ms for _, ms in kernels.values()) / RUNS
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:15]
    print(json.dumps({
        "device": torch.cuda.get_device_name(0),
        "corr_impl": args.corr_impl or "kernel", "runs": RUNS,
        "wall_ms_per_forward": wall_ms,
        "device_kernel_ms_per_forward": busy,
        "device_idle_share": 1.0 - busy / wall_ms if busy else None,
        "launches_per_forward": launches / RUNS,
        "by_category": {
            c: {"ms_per_forward": ms / RUNS,
                "launches_per_forward": n / RUNS,
                "share_of_kernel_time": ms / RUNS / busy if busy else None,
                "kernels": sorted(names)}
            for c, (n, ms, names) in sorted(by_cat.items(), key=lambda kv: -kv[1][1])},
        "top_kernels": [
            {"name": name[:120], "calls_per_forward": n / RUNS,
             "ms_per_forward": ms / RUNS} for name, (n, ms) in top],
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())

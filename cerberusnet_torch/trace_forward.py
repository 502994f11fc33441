"""Where the time of one forward, or one train step, goes on the GPU.

    python3 -m cerberusnet_torch.trace_forward [--variant cerberus_dcv]
        [--train [--config configs/....json]] [--corr-impl plain]
        [--pallas-levels N]

Runs a default-width joint model (``--variant``: ``cerberus``, the
default, or ``cerberus_dcv``) under ``torch.profiler`` for 5 calls after
warmup: a bf16 forward at 512x1024, batch 1, through ``entry``, or with
``--train`` a train step at batch 2 through ``train_entry`` (constant
learning rate) of ``--config``, by default the variant's own experiment
(``configs/cerberus_synthetic.json`` or ``configs/cerberus_dcv.json``).
``--pallas-levels N`` runs CerberusNet's first N encoder levels as fused
kernels (a train step with their reverse-sweep kernel). Prints one JSON
line: wall ms per call, the device's kernel time per call by category
(the fused encoder levels, convolutions, the correlation kernels, warp
gathers and their backward's
scatters, bilinear resizes, concatenations, pads, the optimizer's
multi-tensor kernels, host-to-device copies, fills, other elementwise), the
device's idle share, the number of launches per call (copies and fills
included), the bytes of the host batch a train step uploads, and the top
kernels. A kernel's category comes from a substring
of its name, so each category also lists the names it took, where a
misfiled kernel shows. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

RUNS = 5
TRAIN_CONFIGS = {"cerberus": "configs/cerberus_synthetic.json",
                 "cerberus_dcv": "configs/cerberus_dcv.json"}
# first match wins; kernel names are lower-cased before matching
CATEGORIES = (
    ("correlation", ("corr2d_", "corr1d_")),
    # the fused encoder levels (csrc/encoder_level.cu: tensor cores in
    # bf16, CUDA cores otherwise), before "conv"
    ("encoder_level", ("tc_fwd_kernel", "tc_bwd_kernel", "level_fwd_kernel",
                       "level_bwd_kernel")),
    ("optimizer", ("multi_tensor", "foreach")),
    # copies (the batch's upload from host memory) and fills, not kernels
    ("memcpy", ("memcpy",)),
    ("memset", ("memset",)),
    # nvjet: cuBLAS GEMMs; the model calls no matmul, so these run its
    # convolutions
    ("convolution", ("conv", "xmma", "cudnn", "implicit", "gemm", "cutlass",
                     "sm90", "winograd", "fft", "nvjet")),
    ("warp_gather", ("gather", "scatter")),
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
    ap.add_argument("--variant", choices=sorted(TRAIN_CONFIGS),
                    default="cerberus")
    ap.add_argument("--train", action="store_true",
                    help="trace a train step instead of a forward")
    ap.add_argument("--config", default=None,
                    help="the train step's experiment (default: the "
                         "variant's)")
    ap.add_argument("--pallas-levels", type=int, default=0,
                    help="CerberusNet's encoder levels run as fused kernels")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("trace_forward: no CUDA device", file=sys.stderr)
        return 1
    from cerberusnet_torch.entry import entry, train_entry

    # as chip_smoke.py times them: the f32 classifier without TF32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    upload_bytes = None
    config = None
    if args.train:
        config = args.config or TRAIN_CONFIGS[args.variant]
        fused = ({"model": {"pallas_levels": args.pallas_levels,
                            "pallas_grad": "pallas"}}
                 if args.pallas_levels else {})
        trainer, (batch,) = train_entry(config, corr_impl=args.corr_impl,
                                        optim={"schedule": "constant"},
                                        **fused)
        upload_bytes = sum(v.nbytes for v in batch.values())

        def call():
            trainer.train_step(batch)
    else:
        forward, imgs = entry(corr_impl=args.corr_impl,
                              variant=args.variant,
                              pallas_levels=args.pallas_levels)

        def call():
            forward(*imgs)
    for _ in range(3):
        call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(RUNS):
            call()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / RUNS

    kernels = {}
    for evt in prof.events():
        # a record_function range (the optimizer's step) also shows on the
        # device's timeline; its time is that of the kernels it holds
        if (evt.device_type != torch.autograd.DeviceType.CUDA
                or getattr(evt, "is_user_annotation", False)):
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
        "call": "train_step" if args.train else "forward",
        "variant": trainer.config.model.variant if args.train
        else args.variant, "config": config,
        "corr_impl": args.corr_impl or "kernel",
        "pallas_levels": args.pallas_levels, "runs": RUNS,
        "wall_ms_per_call": wall_ms,
        "device_kernel_ms_per_call": busy,
        "device_idle_share": 1.0 - busy / wall_ms if busy else None,
        "launches_per_call": launches / RUNS,
        "upload_bytes_per_call": upload_bytes,
        "by_category": {
            c: {"ms_per_call": ms / RUNS,
                "launches_per_call": n / RUNS,
                "share_of_kernel_time": ms / RUNS / busy if busy else None,
                "kernels": sorted(names)}
            for c, (n, ms, names) in sorted(by_cat.items(), key=lambda kv: -kv[1][1])},
        "top_kernels": [
            {"name": name[:120], "launches_per_call": n / RUNS,
             "ms_per_call": ms / RUNS} for name, (n, ms) in top],
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())

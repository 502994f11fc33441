"""Where the time of one forward, or one train step, goes on the GPU.

    python3 -m cerberusnet_torch.trace_forward [--variant cerberus_dcv|cerberus_raft]
        [--train [--config configs/....json]] [--corr-impl plain]
        [--pallas-levels N] [--raft-lookup gather] [--unfused] [--hw H W]

Runs a default-width joint model (``--variant``: ``cerberus``, the
default, ``cerberus_dcv`` or ``cerberus_raft``) under ``torch.profiler``
for 5 calls after warmup: a bf16 forward at 512x1024, batch 1, through
``entry``, or with ``--train`` a train step at batch 2 through
``train_entry`` (constant learning rate) of ``--config``, by default the
variant's own experiment (``TRAIN_CONFIGS``). ``--pallas-levels N`` runs
CerberusNet's first N encoder levels as fused kernels (a train step with
their reverse-sweep kernel); ``--raft-lookup`` sets CerberusRAFT's volume
lookup (by default the config's, or ``entry``'s onehot); ``--unfused``
builds the PWC and DCV models' naive estimators (``model.fused`` False)
in place of the reference's default fused ones; ``--hw`` sets the
forward's frame (an H that is no multiple of 64, such as RAFT's 368x768
crops, takes the FPN head's resizes off the power-of-2 ratios). Prints
one JSON
line: wall ms per call, the device's kernel time per call by category
(the fused encoder levels, convolutions, the correlation kernels, warp
gathers and their backward's scatters, bilinear resizes, concatenations,
pads, softmax, the optimizer's multi-tensor kernels, host-to-device
copies, fills, other elementwise), the device's idle share, the number of
launches per call (copies and fills included), the bytes of the host
batch a train step uploads, and the top kernels. A kernel's category
comes from a substring of its name, so each category also lists the names
it took, where a misfiled kernel shows; but a kernel that a RAFT stage
launched takes the stage's category (``RAFT_STAGES``: the all-pairs
volumes and their pooling, the lookup, the convex upsampling, each with
its backward), read from the operator that launched it. Needs a CUDA
device.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile, record_function

RUNS = 5
TRAIN_CONFIGS = {"cerberus": "configs/cerberus_synthetic.json",
                 "cerberus_dcv": "configs/cerberus_dcv.json",
                 "cerberus_raft": "configs/cerberus_raft.json"}
# the functions of cerberusnet_torch.models.raft traced as ranges, by the
# stage their kernels count under
RAFT_STAGES = {"allpairs_correlation": "raft_allpairs",
               "allpairs_correlation_1d": "raft_allpairs",
               "correlation_pyramid": "raft_allpairs",
               "correlation_pyramid_1d": "raft_allpairs",
               "corr_lookup": "raft_lookup",
               "corr_lookup_1d": "raft_lookup",
               "convex_upsample": "raft_upsample"}
BACKWARD = "autograd::engine::evaluate_function"
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
    ("softmax", ("softmax",)),
)


def category(name: str) -> str:
    low = name.lower()
    for cat, keys in CATEGORIES:
        if any(k in low for k in keys):
            return cat
    return "other"


@contextlib.contextmanager
def raft_ranges(expect: bool = False):
    """Wraps each function of ``RAFT_STAGES`` in a ``record_function``
    range named by its stage for the body, so the operators it runs show
    under that range; the RAFT decoders call them through the module, and
    a caller that bound one by name would escape its stage. Yields the
    calls counted by name; with ``expect``, raises at the end if a name
    was never called (a CerberusRAFT run calls every one)."""
    from cerberusnet_torch.models import raft

    calls = dict.fromkeys(RAFT_STAGES, 0)

    def ranged(fn, name, stage):
        def call(*args, **kw):
            calls[name] += 1
            with record_function(stage):
                return fn(*args, **kw)
        return call

    saved = {name: getattr(raft, name) for name in RAFT_STAGES}
    for name, stage in RAFT_STAGES.items():
        setattr(raft, name, ranged(saved[name], name, stage))
    try:
        yield calls
    finally:
        for name, fn in saved.items():
            setattr(raft, name, fn)
    missed = [name for name, n in calls.items() if not n]
    if expect and missed:
        raise RuntimeError(f"RAFT stage functions never called through "
                           f"cerberusnet_torch.models.raft: {missed}")


def stage_finder(events):
    """A function from a host operator event to its RAFT stage, or None:
    the stage range it ran under, or for an operator of the backward the
    stage of the forward operator whose autograd node it evaluates (the
    node's sequence number links them) with " backward" added."""
    stages = set(RAFT_STAGES.values())

    def enclosing(e, match):
        while e is not None and not match(e.name):
            e = e.cpu_parent
        return e

    def forward_stage(e):
        r = enclosing(e, stages.__contains__)
        return r.name if r is not None else None

    by_seq = {}
    for e in events:
        if e.sequence_nr >= 0 and not e.name.startswith(BACKWARD):
            stage = forward_stage(e)
            if stage:
                by_seq[e.sequence_nr] = stage

    def stage_of(e):
        stage = forward_stage(e)
        if stage:
            return stage
        node = enclosing(e, lambda n: n.startswith(BACKWARD))
        if node is not None and node.sequence_nr in by_seq:
            return f"{by_seq[node.sequence_nr]} backward"
        return None
    return stage_of


def kernel_table(events):
    """{(category, kernel name): [launches, device ms]} over a profile's
    events. Every device event counts (a record_function range, the
    optimizer's step, also shows on the device's timeline, holding the
    kernels it ran: it is skipped), filed by ``category`` of its name,
    but a kernel that a host operator of a RAFT stage launched (the
    profiler lists it in that operator's ``kernels``) moves to the stage."""
    table = {}

    def add(key, n, ms):
        entry = table.setdefault(key, [0, 0.0])
        entry[0] += n
        entry[1] += ms

    for evt in events:
        if (evt.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(evt, "is_user_annotation", False)):
            add((category(evt.name), evt.name), 1,
                evt.device_time_total / 1e3)  # us -> ms
    stage_of = stage_finder(events)
    for e in events:
        if e.device_type != torch.autograd.DeviceType.CPU or not e.kernels:
            continue
        stage = stage_of(e)
        for k in e.kernels if stage else ():
            add((category(k.name), k.name), -1, -k.duration / 1e3)
            add((stage, k.name), 1, k.duration / 1e3)
    # a launch the host lists but the device timeline dropped (at a
    # window's edge) leaves a name's category short of what moved
    return {key: v for key, v in table.items() if v[0] > 0}


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
    ap.add_argument("--raft-lookup", choices=["onehot", "gather"],
                    default=None, help="CerberusRAFT's volume lookup")
    ap.add_argument("--unfused", action="store_true",
                    help="the PWC and DCV variants' naive estimators "
                         "(model.fused False)")
    ap.add_argument("--hw", type=int, nargs=2, default=(512, 1024),
                    help="the forward's frame height and width")
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
        model = ({"pallas_levels": args.pallas_levels,
                  "pallas_grad": "pallas"} if args.pallas_levels else {})
        if args.raft_lookup:
            model["raft_lookup"] = args.raft_lookup
        if args.unfused:
            model["fused"] = False
        trainer, (batch,) = train_entry(config, corr_impl=args.corr_impl,
                                        optim={"schedule": "constant"},
                                        model=model)
        upload_bytes = sum(v.nbytes for v in batch.values())

        def call():
            trainer.train_step(batch)
    else:
        raft = ({"raft_lookup": args.raft_lookup} if args.raft_lookup
                else {})
        forward, imgs = entry(corr_impl=args.corr_impl,
                              variant=args.variant,
                              pallas_levels=args.pallas_levels,
                              hw=tuple(args.hw), model_kw={"fused": False} if args.unfused
                              else None, **raft)

        def call():
            forward(*imgs)
    for _ in range(3):
        call()
    torch.cuda.synchronize()
    with raft_ranges(expect=args.variant == "cerberus_raft"), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(RUNS):
            call()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / RUNS

    kernels = kernel_table(prof.events())
    by_cat, launches = {}, 0
    for (cat_name, name), (count, ms) in kernels.items():
        cat = by_cat.setdefault(cat_name, [0, 0.0, []])
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
        "raft_lookup": (trainer.config.model.raft_lookup if args.train
                        else args.raft_lookup or "onehot")
        if args.variant == "cerberus_raft" else None,
        "corr_impl": args.corr_impl or "kernel",
        "pallas_levels": args.pallas_levels, "fused": not args.unfused,
        "hw": None if args.train else list(args.hw),
        "runs": RUNS,
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
            {"name": name[:120], "category": cat,
             "launches_per_call": n / RUNS, "ms_per_call": ms / RUNS}
            for (cat, name), (n, ms) in top],
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())

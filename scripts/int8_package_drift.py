#!/usr/bin/env python3
"""Where an AOTInductor package of the int8 CerberusNet departs from the
eager int8 forward (``quant.quantized_apply``), on the card.

    PYTHONPATH=. python3 scripts/int8_package_drift.py [--out DIR]

Builds the int8 model as ``chip_smoke.py`` does (seed 0's default-width
CerberusNet, calibrated on the frames of seeds 11 and 12, quantized from
its float32 weights, stripped) and exports it under ``quant_interception``
(the ``quant_int8`` artifact). Then, each package compiled in a process of
its own, all at once:

  conv        one int8 conv (``encoder.blocks.6.conv``: quantize, im2col,
              ``torch._int_mm``, epilogue) on its input captured from the
              eager forward, against ``ptq._int8_conv`` on it
  int8        the whole int8 program, Inductor's default settings
  int8_casts  the same with ``emulate_precision_casts`` (fused kernels
              round to bf16 where the eager ops would)
  int8_o0     the same with the C++ wrapper built at -O0 (compile time)
  bf16        the float bf16 program, against the eager bf16 forward

Each line: bit equality and the relative L2 of every output against its
eager counterpart, and for the whole programs their distance from the
float32 eager forward beside quantized_apply's own. The card's name and
power limit head the output. It runs only where CUDA is.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import torch

HW = (512, 1024)
CALIB_SEEDS = (11, 12)
HEADS = ("seg_logits", "flow", "disp")
CONV = "encoder.blocks.6.conv"


def seeded(dtype):
    from cerberusnet_torch.models.cerberus import CerberusNet
    from cerberusnet_torch.weights import init_params

    model = init_params(CerberusNet(dtype=dtype),
                        torch.Generator().manual_seed(0))
    return model.cuda().eval()


def int8_model():
    from cerberusnet_torch.entry import make_frames
    from cerberusnet_torch.quant import calibrate, quantize

    model = seeded(torch.bfloat16)
    kernels = {n[:-len(".weight")]: p.detach() for n, p in
               seeded(torch.float32).named_parameters()
               if n.endswith(".weight")}
    scales = calibrate(model, [make_frames(s, HW) for s in CALIB_SEEDS])
    return quantize(model, scales, strip=True, weights=kernels)


class OneConv(torch.nn.Module):
    def __init__(self, conv):
        super().__init__()
        self.conv = conv

    def forward(self, x):
        from cerberusnet_torch.quant import ptq

        return (ptq._int8_conv(self.conv, x),)


def package(art, configs):
    """Packages ``art`` in a process of its own with these Inductor
    ``configs`` besides the C++ compiler; (seconds, rc, stderr tail)."""
    code = ("import json, sys, torch\n"
            "import cerberusnet_torch.ops.library\n"
            "from cerberusnet_torch.export.aot import load_exported, "
            "openmp_cxx\n"
            "art, cfg = sys.argv[1], json.loads(sys.argv[2])\n"
            "cfg['cpp.cxx'] = (None, openmp_cxx())\n"
            "with torch.no_grad():\n"
            "    torch._inductor.aoti_compile_and_package(\n"
            "        load_exported(art), package_path=art + '/model_aoti.pt2',"
            "\n        inductor_configs=cfg)\n")
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, "-c", code, art, json.dumps(configs)],
                       capture_output=True, text=True, timeout=1200)
    return time.perf_counter() - t0, p.returncode, p.stderr[-1500:]


def ms_per_call(fn, runs=20):
    """Median CUDA-event ms of one call, after 3 warmup calls."""
    for _ in range(3):
        fn()
    pairs = []
    for _ in range(runs):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return sorted(a.elapsed_time(b) for a, b in pairs)[runs // 2]


def distances(got, want):
    rows = []
    for g, w in zip(got, want):
        g, w = g.float(), w.float()
        rows.append({"bit_equal": torch.equal(g, w),
                     "rel_l2": ((g - w).norm() / w.norm()).item(),
                     "differing_share": (g != w).float().mean().item()})
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None, help="keep the artifacts here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("int8_package_drift: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    from cerberusnet_torch.entry import make_frames
    from cerberusnet_torch.export.aot import (
        DeployOutputs,
        export_inference,
        save_exported,
    )
    from cerberusnet_torch.quant import ptq, quantized_apply

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({"card": smi, "torch": torch.__version__}), flush=True)
    root = args.out or tempfile.mkdtemp(prefix="int8_drift_")
    frames = make_frames(1, HW)
    model = int8_model()
    seen = {}
    handle = model.get_submodule(CONV).register_forward_pre_hook(
        lambda m, a: seen.setdefault("x", a[0].detach().clone()))
    with torch.no_grad():
        want8 = quantized_apply(model, *frames)
    handle.remove()
    conv = model.get_submodule(CONV)
    with torch.no_grad():
        want_conv = ptq._int8_conv(conv, seen["x"])
    with torch.no_grad(), ptq.quant_interception(model):
        save_exported(export_inference(DeployOutputs(model), frames),
                      f"{root}/int8")
        save_exported(export_inference(OneConv(conv), (seen["x"],)),
                      f"{root}/conv")
    bf16 = seeded(torch.bfloat16)
    with torch.no_grad():
        want16 = bf16(*frames)
        save_exported(export_inference(DeployOutputs(bf16), frames),
                      f"{root}/bf16")
        f32 = seeded(torch.float32)(*frames)
    for name in ("int8_casts", "int8_o0"):
        shutil.copytree(f"{root}/int8", f"{root}/{name}")
    jobs = {"conv": {}, "int8": {}, "bf16": {},
            "int8_casts": {"emulate_precision_casts": True},
            "int8_o0": {"aot_inductor.compile_wrapper_opt_level": "O0"}}
    with ThreadPoolExecutor(len(jobs)) as pool:
        done = dict(zip(jobs, pool.map(
            lambda kv: package(f"{root}/{kv[0]}", kv[1]), jobs.items())))
    for name, (secs, rc, err) in done.items():
        line = {"package": name, "seconds": secs, "rc": rc}
        if rc:
            print(json.dumps({**line, "stderr": err}), flush=True)
            continue
        pkg = torch._inductor.aoti_load_package(
            os.path.join(root, name, "model_aoti.pt2"))
        with torch.no_grad():
            got = pkg(seen["x"]) if name == "conv" else pkg(*frames)
            if name != "conv":
                line["ms_per_frame"] = ms_per_call(lambda: pkg(*frames))
        if name == "conv":
            line["vs_eager"] = distances(got, [want_conv])
        else:
            want = want16 if name == "bf16" else want8
            line["vs_eager"] = dict(zip(HEADS, distances(
                got, [want[k] for k in HEADS])))
            line["vs_f32"] = {k: distances([g], [f32[k]])[0]["rel_l2"]
                              for g, k in zip(got, HEADS)}
            line["eager_vs_f32"] = {k: distances([want[k]], [f32[k]])[0][
                "rel_l2"] for k in HEADS}
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The C++ runner (csrc/runner.cc, cerberus_runner) end to end on the CPU:
built with g++ (export/runner.py), a tiny stand-in with the deployment
signature (three (1, H, W, 3) frames in; seg_logits, flow and disp out)
exported (export/aot.py) and compiled with AOTInductor
(package_for_runner), then run by the runner with --inputs and
--dump-outputs, --serve (two INFER requests and one PNGS) and --pngs, on
the separate-frame and the stacked signatures. Each output is held bit
for bit to the same package loaded into this process
(torch._inductor.aoti_load_package): both run one compiled library on the
same bytes. And the runner refuses --device cuda where torch finds no
device, and a package exported for another platform.

Marked slow (tier-1 skips it): about 12 s of g++ and 40-60 s of Inductor
compiles. Run it before a chip run of the runner:
``JAX_PLATFORMS=cpu python -m pytest tests/test_torch_runner_cpu.py -m slow``.
The stand-in holds no cerberus:: operator (a CPU export holds the plain
versions); the operator library and CerberusNet at full width run on the
card (``chip_smoke.py --only runner``).
"""

import json
import os
import subprocess

import pytest
import torch
import torch.nn as nn

from cerberusnet_torch.export import runner as runner_build
from cerberusnet_torch.export import runner_io
from cerberusnet_torch.export.aot import (
    DeployOutputs,
    export_inference,
    package_for_runner,
    save_exported,
)

pytestmark = pytest.mark.slow

HW = (16, 24)


class StandIn(nn.Module):
    """Three NHWC frames -> {"seg_logits": 19, "flow": 2, "disp": 1
    channels}, through one shared conv; ``stacked_input`` takes the three
    frames as one (3, H, W, 3) tensor, as CerberusNet's does."""

    def __init__(self, stacked_input=False):
        super().__init__()
        torch.manual_seed(0)
        self.stacked_input = stacked_input
        self.enc = nn.Conv2d(3, 8, 3, padding=1)
        self.heads = nn.ModuleDict({
            "seg_logits": nn.Conv2d(8, 19, 1), "flow": nn.Conv2d(16, 2, 3,
                                                                  padding=1),
            "disp": nn.Conv2d(16, 1, 3, padding=1)})

    def forward(self, *frames):
        if self.stacked_input:
            frames = frames[0].split(1)
        left, right, temporal = (
            torch.relu(self.enc(f.permute(0, 3, 1, 2).float()))
            for f in frames)
        out = {"seg_logits": self.heads["seg_logits"](left),
               "flow": self.heads["flow"](torch.cat([left, temporal], 1)),
               "disp": self.heads["disp"](torch.cat([left, right], 1))}
        return {k: v.permute(0, 2, 3, 1) for k, v in out.items()}


@pytest.fixture(scope="module")
def built():
    return runner_build.build_runner()[0]


@pytest.fixture(scope="module")
def packages(tmp_path_factory):
    root = tmp_path_factory.mktemp("runner")
    dirs = {}
    for name, stacked in (("separate", False), ("stacked", True)):
        n = 1 if stacked else 3
        example = tuple(torch.zeros((3 if stacked else 1, *HW, 3),
                                    dtype=torch.bfloat16) for _ in range(n))
        d = str(root / name)
        save_exported(export_inference(
            DeployOutputs(StandIn(stacked).eval()), example), d)
        package_for_runner(d)
        dirs[name] = d
    return dirs


@pytest.mark.parametrize("name", ["separate", "stacked"])
def test_inputs_and_dump_equal_the_python_package(built, packages, name):
    report = runner_io.verify(packages[name], built, device="cpu", iters=2)
    assert report["bit_equal"], report
    assert [o["shape"] for o in report["outputs"]] == [
        [1, *HW, c] for c in (19, 2, 1)]
    run = report["runner"]
    assert run["calls"] == 3 and run["num_outputs"] == 3
    assert run["launches"] == {}  # no operator library on the CPU


@pytest.mark.parametrize("name", ["separate", "stacked"])
def test_pngs_equal_the_python_path(built, packages, name):
    report = runner_io.verify_pngs(packages[name], built, device="cpu")
    assert report["bit_equal"], report


def test_serve_answers_and_quits(built, packages):
    report = runner_io.verify_serve(packages["separate"], built,
                                    device="cpu", requests=2)
    assert report["rc"] == 0
    assert [r["request"] for r in report["requests"]] == [
        "INFER", "INFER", "PNGS"]
    assert report["bit_equal"], report


def test_serve_error_exits_nonzero(built, packages):
    proc = subprocess.run(
        [str(built), "--model", packages["separate"], "--device", "cpu",
         "--serve"], input=b"HELLO\n", capture_output=True, timeout=120)
    lines = proc.stdout.decode().splitlines()
    assert lines[0] == "READY 3 3"
    assert lines[1].startswith("ERR unknown request")
    assert proc.returncode == 1


def test_refusals(built, packages, tmp_path):
    d = packages["separate"]
    if not torch.cuda.is_available():
        proc = subprocess.run([str(built), "--model", d, "--device", "cuda"],
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode != 0
        assert "no CUDA device" in proc.stderr
    # a package exported on the card, run on the CPU
    other = tmp_path / "cuda_manifest"
    other.mkdir()
    with open(os.path.join(d, "manifest.json")) as f:
        m = json.load(f)
    m["platforms"] = ["cuda"]
    (other / "manifest.json").write_text(json.dumps(m))
    proc = subprocess.run([str(built), "--model", str(other), "--device",
                           "cpu"], capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert "compiled for [cuda], not cpu" in proc.stderr


def test_runner_links_no_python(built):
    ldd = subprocess.run(["ldd", str(built)], capture_output=True, text=True)
    assert ldd.returncode == 0
    assert "libpython" not in ldd.stdout

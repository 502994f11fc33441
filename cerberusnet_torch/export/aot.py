"""Ahead-of-time export for deployment: port of
``cerberusnet_tpu/export/aot.py`` (the reference's ONNX -> TensorRT path).

The reference serialises the jitted inference function to StableHLO with
``jax.export``, the weights inside as constants. Here ``torch.export``
builds an ``ExportedProgram`` with static shapes and the weights inside,
saved with ``torch.export.save``. The hand kernels ride inside it as the
operators of ``ops/library.py`` (``cerberus::corr2d_fwd`` and the rest):
a program exported from CUDA inputs launches them when it is called, and
their wrappers count the launches as in an eager call. A program exported
from CPU inputs holds the plain versions.

Artifact: ``<dir>/model.pt2`` and ``<dir>/manifest.json`` with the
reference's fields: ``platforms`` (``["cuda"]`` or ``["cpu"]``), and
``inputs`` and ``outputs`` as ``{"shape": [...], "dtype": "bfloat16"}``,
dtypes as numpy spells them. The reference's ``model.mlir`` (StableHLO
text) and ``compile_options.pb`` (the C++ PJRT runner's compile options)
have no counterpart.

Consumers: ``load_exported(dir)`` needs only torch and this package's
operator registrations (``ops/library.py``, imported here); call
``load_exported(dir).module()(*inputs)`` under ``torch.no_grad()``.
``package_for_runner(dir)`` compiles the program ahead of time with
AOTInductor into ``<dir>/model_aoti.pt2``, which the C++ runner
(``csrc/runner.cc``, built by ``export/runner.py``) runs without Python,
and which ``torch._inductor.aoti_load_package`` loads into a Python
process, where its operators are ``ops/library.py``'s. An export does not
package itself: the Inductor compile costs minutes at full width.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import tempfile

import torch
import torch.nn as nn

from cerberusnet_torch.ops import library  # noqa: F401  the operators

# the deployment surface of a model: its full-resolution outputs, in order
DEPLOY_OUTPUTS = ("seg_logits", "flow", "disp")


class DeployOutputs(nn.Module):
    """``model``'s forward returning the tuple of its ``DEPLOY_OUTPUTS``
    (those it has), in that order."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, *frames):
        out = self.model(*frames)
        return tuple(out[k] for k in DEPLOY_OUTPUTS if k in out)


def export_inference(fn: nn.Module,
                     example_args) -> torch.export.ExportedProgram:
    """``torch.export`` of ``fn``, a module whose forward takes only
    tensors (its weights inside), at the static shapes and types of
    ``example_args``, on their device."""
    with torch.no_grad():
        return torch.export.export(fn, tuple(example_args), strict=False)


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype)[len("torch."):]


def _spec(t) -> dict:
    return {"shape": list(t.shape), "dtype": _dtype_name(t.dtype)}


def _signature(exported: torch.export.ExportedProgram):
    """(inputs, outputs): the fake tensors of the program's user inputs
    and outputs."""
    nodes = {n.name: n for n in exported.graph.nodes}
    sig = exported.graph_signature
    return ([nodes[n].meta["val"] for n in sig.user_inputs],
            [nodes[n].meta["val"] for n in sig.user_outputs])


def save_exported(exported: torch.export.ExportedProgram,
                  out_dir: str) -> str:
    """Writes ``<out_dir>/model.pt2`` and ``manifest.json``; returns
    ``out_dir``."""
    os.makedirs(out_dir, exist_ok=True)
    torch.export.save(exported, os.path.join(out_dir, "model.pt2"))
    inputs, outputs = _signature(exported)
    manifest = {
        "platforms": sorted({t.device.type for t in inputs}),
        "inputs": [_spec(t) for t in inputs],
        "outputs": [_spec(t) for t in outputs],
    }
    with open(os.path.join(out_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=2)
    return out_dir


def load_exported(path_or_dir: str) -> torch.export.ExportedProgram:
    """The program of an artifact (its directory, or its ``model.pt2``);
    call ``.module()(*inputs)`` on it."""
    path = path_or_dir
    if os.path.isdir(path):
        path = os.path.join(path, "model.pt2")
    return torch.export.load(path)


def export_cerberus(model: nn.Module, hw=(512, 1024), batch: int = 1,
                    dtype: torch.dtype = torch.bfloat16,
                    out_dir: str = "export_artifact") -> str:
    """Exports the three-headed inference graph of ``model`` (NHWC left,
    right and temporal frames of ``dtype`` in; seg_logits, flow, disp out)
    on the model's device, weights inside; returns ``out_dir``."""
    h, w = hw
    device = next(model.parameters()).device
    example = tuple(torch.zeros((batch, h, w, 3), dtype=dtype, device=device)
                    for _ in range(3))
    return save_exported(export_inference(DeployOutputs(model), example),
                         out_dir)


RUNNER_PACKAGE = "model_aoti.pt2"


def openmp_cxx() -> str:
    """A C++ compiler that links OpenMP, which the C++ wrapper of an
    AOTInductor package links: ``$CXX`` (the one Inductor takes by
    default) where it can, else ``g++`` on the PATH. A ``$CXX`` built
    without libgomp fails that link."""
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "omp.cc")
        with open(src, "w") as f:
            f.write("int main() { return 0; }\n")
        tried = []
        for cxx in (os.environ.get("CXX"), "g++"):
            path = shutil.which(cxx) if cxx else None
            if path is None:
                continue
            tried.append(path)
            proc = subprocess.run([path, "-fopenmp", src, "-o",
                                   os.path.join(tmp, "a.out")],
                                  capture_output=True)
            if proc.returncode == 0:
                return path
    raise RuntimeError(f"no C++ compiler here links OpenMP (-fopenmp), "
                       f"which an AOTInductor package needs; tried {tried}")


def package_for_runner(export_dir: str) -> str:
    """Compiles the artifact's program with AOTInductor on the device it
    was exported on (its weights inside) into
    ``<export_dir>/model_aoti.pt2``; returns that path. The
    ``cerberus::`` operators stay calls of the operators, which the loading
    process provides."""
    program = load_exported(export_dir)
    path = os.path.join(export_dir, RUNNER_PACKAGE)
    with torch.no_grad():
        return torch._inductor.aoti_compile_and_package(
            program, package_path=path,
            inductor_configs={"cpp.cxx": (None, openmp_cxx())})

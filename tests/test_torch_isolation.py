"""The port stands alone: cerberusnet_torch and chip_smoke.py import nothing
of JAX, flax, optax, ml_dtypes, the JAX package or tools/, and refuse to run
where they must not (no CUDA device, no nvcc, no port beside
chip_smoke.py)."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from cerberusnet_torch.testing import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
PACKAGE = REPO / "cerberusnet_torch"
BLOCKED = ("jax", "jaxlib", "flax", "optax", "ml_dtypes", "cerberusnet_tpu",
           "tools")

IMPORT_ALL_BLOCKED = f"""
import importlib, importlib.abc, pkgutil, sys
BLOCKED = {BLOCKED!r}

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked import of {{name}}")
        return None

sys.meta_path.insert(0, Block())
import cerberusnet_torch
names = [m.name for m in pkgutil.walk_packages(
    cerberusnet_torch.__path__, "cerberusnet_torch.")]
for name in names:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not leaked, leaked
print(" ".join(names))
"""


def run_python(code, cwd=REPO, env=None):
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_every_module_imports_with_jax_blocked():
    proc = run_python(IMPORT_ALL_BLOCKED)
    assert proc.returncode == 0, proc.stderr
    names = proc.stdout.split()
    assert len(names) >= 39  # every module was imported
    assert {f"cerberusnet_torch.{m}" for m in (
        "models.dcv_flow", "models.segmentation", "data.augment",
        "data.cityscapes", "data.encodings", "data.io", "data.kitti",
        "data.native_io", "utils.tblogger", "data.flow_datasets", "eval",
        "eval.tta", "eval.tiled", "eval.submission", "ops.library", "export",
        "export.aot", "export.runner", "export.runner_io", "quant",
        "quant.ptq", "quant.qat", "train.debug_nans", "parallel",
        "parallel.mesh", "parallel.halo", "bench", "utils.benchutil",
        "utils.flops", "examples", "examples.video_stream",
        "examples.raft_anytime_inference", "examples.demo_end_to_end",
        "examples.migrate_from_torch")} <= set(names)


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize(
    "path",
    sorted(PACKAGE.rglob("*.py")) + [REPO / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(REPO)),
)
def test_source_names_no_reference_import(path):
    bad = sorted(set(_imported_roots(path)) & set(BLOCKED))
    assert not bad, f"{path.name} imports {bad}"


def test_entry_without_cuda_raises():
    from cerberusnet_torch.entry import entry

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: entry() runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry()


def test_entry_on_cpu_when_asked():
    from cerberusnet_torch.entry import entry

    forward, imgs = entry(device="cpu", dtype=torch.float32, hw=(64, 64))
    out = forward(*imgs)
    assert tuple(out["seg_logits"].shape) == (1, 64, 64, 19)
    assert tuple(out["flow"].shape) == (1, 64, 64, 2)
    assert tuple(out["disp"].shape) == (1, 64, 64, 1)
    assert sorted(out["flow_pyramid"]) == [2, 3, 4, 5, 6]
    assert all(torch.isfinite(out[k]).all() for k in ("flow", "disp"))


def test_build_imports_without_nvcc():
    env = {k: v for k, v in os.environ.items()
           if k not in ("CUDA_HOME", "CUDA_PATH")}
    env["PATH"] = os.path.dirname(sys.executable)
    code = (
        "from cerberusnet_torch.ops import build\n"
        "try:\n"
        "    build.find_nvcc()\n"
        "except RuntimeError as e:\n"
        "    print('refused:', e)\n"
    )
    proc = run_python(code, env=env)
    assert proc.returncode == 0, proc.stderr
    if "refused" not in proc.stdout:
        pytest.skip("an nvcc is installed where torch's CUDA_HOME points")
    assert "nvcc not found" in proc.stdout


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_refuses_without_card_or_port(where, tmp_path):
    if torch.cuda.is_available() and where == "repo":
        pytest.skip("a CUDA device is present: chip_smoke.py runs there")
    script = (REPO / "chip_smoke.py").read_text()
    cwd = REPO
    if where == "alone":
        (tmp_path / "chip_smoke.py").write_text(script)
        cwd = tmp_path
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout

"""Builds the port's CUDA sources with nvcc and loads them with ctypes.

Each ``csrc/<name>.cu`` becomes one shared library with a plain C interface,
compiled for Hopper (``sm_90a``) into ``cerberusnet_torch/_build/`` (ignored
by git) on first use. The file name carries a hash of the source, the
headers in ``csrc/`` and the flags, so an edited source or header is
rebuilt and a stale library is never loaded.
No PyTorch header is compiled, which keeps a build to seconds. nvcc's
output, with ptxas's registers, shared memory and spills for each kernel
(``-Xptxas -v``), is kept beside the library (``build_log``). A build may
add preprocessor defines (``-D``), which a measurement build of a source
uses; its library is a separate file.

Importing this module needs neither nvcc nor a GPU: both are looked up only
when a library is built.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: dict[tuple, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, then $PATH, then PyTorch's CUDA_HOME."""
    candidates = []
    for var in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(var):
            candidates.append(Path(os.environ[var]) / "bin" / "nvcc")
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(Path(on_path))
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        candidates.append(Path(CUDA_HOME) / "bin" / "nvcc")
    for cand in candidates:
        if cand.is_file():
            return str(cand)
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, $CUDA_PATH/bin, $PATH and "
        "torch's CUDA_HOME): the CUDA kernels cannot be built here"
    )


def flags(defines: tuple = ()) -> tuple:
    """nvcc's flags with ``-D<define>`` for each of ``defines``."""
    return (*NVCC_FLAGS, *(f"-D{d}" for d in defines))


def library_path(name: str, defines: tuple = ()) -> Path:
    """The library's path, named by a hash of the source, every header in
    ``csrc/`` (which a source may include) and the flags."""
    digest = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        digest.update(header.name.encode() + header.read_bytes())
    digest.update(" ".join(flags(defines)).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(name: str, defines: tuple = ()) -> float | None:
    """Compiles ``csrc/<name>.cu`` (with ``defines``) unless its library
    exists.

    Returns the seconds nvcc took, or None if nothing was built. Raises
    RuntimeError with nvcc's output if it fails."""
    out = library_path(name, defines)
    if out.exists():
        return None
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # write under a private name, then rename: a concurrent build of the same
    # source never exposes a half-written library
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [nvcc, *flags(defines), "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed for {name}.cu (rc {proc.returncode}):\n{proc.stdout}")
    out.with_suffix(".log").write_text(proc.stdout)
    os.replace(tmp, out)
    return time.perf_counter() - t0


def build_log(name: str, defines: tuple = ()) -> str:
    """nvcc's output from building ``csrc/<name>.cu`` ("" if it was built
    without one)."""
    log = library_path(name, defines).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(name: str, defines: tuple = ()) -> ctypes.CDLL:
    """The library built from ``csrc/<name>.cu`` with ``defines``, built on
    first use."""
    lib = _loaded.get((name, defines))
    if lib is None:
        build(name, defines)
        lib = _loaded[(name, defines)] = ctypes.CDLL(
            str(library_path(name, defines)))
    return lib

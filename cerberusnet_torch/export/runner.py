"""Builds the C++ runner of the exported program (``csrc/runner.cc``,
``cerberus_runner``) and the C++ operator library of the hand kernels
(``csrc/cerberus_ops.cc``, ``libcerberus_ops``).

Both are compiled with g++ against the installed torch's headers and
libraries (``torch.utils.cpp_extension.include_paths()`` and
``library_paths()``, found again at run time through an rpath), never
including ``torch/extension.h``, so a build takes seconds, not minutes.
They go into ``cerberusnet_torch/_build/`` (ignored by git) on first use,
each file named by a hash of its sources, the headers in ``csrc/``, the
flags and the torch version, as ``ops/build.py`` names the kernel
libraries: an edited source is rebuilt and a stale binary never loaded.

The runner links the native PNG decoder from its unchanged source
(``native/dataload/png_decode.cc``, as ``data/native_io.py`` builds it),
libtorch and, where torch has CUDA, torch's CUDA libraries (which register
AOTInductor's CUDA runner); it links no libpython. The operator library is
built only where torch has CUDA: it includes c10-cuda's headers and links
the two nvcc-built kernel libraries of ``ops/build.py``. Never load it into
a Python process: its ``TORCH_LIBRARY(cerberus)`` would collide with the
operators ``ops/library.py`` defines.

Importing this module needs no compiler: g++ is looked up when a binary is
built.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

from cerberusnet_torch.ops import build

REPO_ROOT = build.PACKAGE_DIR.parent
RUNNER_SOURCES = (build.CSRC_DIR / "runner.cc",
                  REPO_ROOT / "native" / "dataload" / "png_decode.cc")
OPS_SOURCE = build.CSRC_DIR / "cerberus_ops.cc"
# the nvcc-built libraries whose C entry points the operators call
KERNEL_LIBRARIES = ("correlation", "encoder_level")


def _cuda() -> bool:
    return torch.version.cuda is not None


def _compile_flags(cuda_headers: bool) -> list:
    from torch.utils.cpp_extension import include_paths

    flags = ["-O2", "-std=c++17", "-fPIC",
             f"-D_GLIBCXX_USE_CXX11_ABI={int(torch.compiled_with_cxx11_abi())}"]
    flags += [f"-I{p}" for p in include_paths()]
    if cuda_headers:
        flags.append(f"-I{Path(build.find_nvcc()).parent.parent / 'include'}")
    return flags


def _link_flags() -> list:
    from torch.utils.cpp_extension import library_paths

    libs = ["-ltorch", "-ltorch_cpu", "-lc10"]
    if _cuda():
        libs += ["-ltorch_cuda", "-lc10_cuda"]
    paths = library_paths()
    return ([f"-L{p}" for p in paths] + [f"-Wl,-rpath,{p}" for p in paths]
            # linked even where no symbol is used: torch_cuda registers the
            # CUDA runner of AOTInductor when it loads
            + ["-Wl,--no-as-needed", *libs, "-Wl,--as-needed"])


def _output(stem: str, suffix: str, inputs, flags) -> Path:
    digest = hashlib.sha256(torch.__version__.encode())
    for path in inputs:
        digest.update(Path(path).name.encode() + Path(path).read_bytes())
    for header in sorted(build.CSRC_DIR.glob("*.cuh")):
        digest.update(header.name.encode() + header.read_bytes())
    digest.update(" ".join(flags).encode())
    return build.BUILD_DIR / f"{stem}-{digest.hexdigest()[:16]}{suffix}"


def _compile(out: Path, argv: list) -> float | None:
    """Runs g++ ``argv`` into ``out`` unless it exists (through a private
    name, then a rename); the seconds it took, or None."""
    if out.exists():
        return None
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++ or $CXX) to build "
                           f"{out.name}")
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([cxx, *argv, "-o", str(tmp)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {out.name} failed (rc "
                           f"{proc.returncode}):\n{proc.stdout[-6000:]}")
    os.replace(tmp, out)
    return time.perf_counter() - t0


def runner_path() -> Path:
    """Where ``cerberus_runner`` is built."""
    return _output("cerberus_runner", "", RUNNER_SOURCES,
                   _compile_flags(False) + _link_flags())


def build_runner() -> tuple[Path, float | None]:
    """(the runner, the seconds g++ took or None if it was built)."""
    out = runner_path()
    return out, _compile(out, [*_compile_flags(False),
                               *map(str, RUNNER_SOURCES), *_link_flags(),
                               "-lz", "-ldl"])


def ops_path() -> Path:
    """Where ``libcerberus_ops`` is built: named by its source, the
    headers and the kernel libraries' own hashed names."""
    if not _cuda():
        raise RuntimeError("the C++ operator library needs torch built with "
                           "CUDA (it calls the CUDA kernels)")
    kernels = [str(build.library_path(n)) for n in KERNEL_LIBRARIES]
    return _output("libcerberus_ops", ".so", [OPS_SOURCE],
                   _compile_flags(True) + _link_flags() + kernels)


def build_ops() -> tuple[Path, float | None]:
    """(the operator library, the seconds g++ took or None if it was
    built); builds the kernel libraries first where they are missing."""
    for name in KERNEL_LIBRARIES:
        build.build(name)
    out = ops_path()
    kernels = [str(build.library_path(n)) for n in KERNEL_LIBRARIES]
    return out, _compile(out, ["-shared", *_compile_flags(True),
                               str(OPS_SOURCE), *kernels,
                               f"-Wl,-rpath,{build.BUILD_DIR}",
                               *_link_flags()])

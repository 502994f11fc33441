"""ctypes binding of the native PNG decoder, a copy of the wrapper in
``cerberusnet_tpu/data/native_io.py``.

``native/dataload/libpng_decode.so`` (built from ``png_decode.cc``; it
links only libz and libstdc++) decodes the PNGs KITTI-2015 and Cityscapes
ship: 8- and 16-bit gray, gray + alpha, RGB and RGBA, not interlaced. It
drops the GIL for the call, so the loader's decode threads run in
parallel. When the committed library does not load on a machine, the
first use builds it from the source with ``g++ -O2 -shared -fPIC ... -lz``
into ``cerberusnet_torch/_build/`` (ignored by git, the file named by a
hash of the source), as ``ops/build.py``
builds the kernels. ``available()`` says whether either loads.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

REPO_ROOT = Path(__file__).resolve().parents[2]
SOURCE = REPO_ROOT / "native" / "dataload" / "png_decode.cc"
COMMITTED = SOURCE.with_name("libpng_decode.so")
BUILD_DIR = REPO_ROOT / "cerberusnet_torch" / "_build"

_lock = threading.Lock()
_state: dict = {}


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.cnt_png_decode.restype = ctypes.c_int
    lib.cnt_png_decode.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_uint32),
        ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_uint32)]
    lib.cnt_png_free.restype = None
    lib.cnt_png_free.argtypes = [ctypes.c_void_p]
    lib.cnt_png_error.restype = ctypes.c_char_p
    lib.cnt_png_error.argtypes = [ctypes.c_int]
    return lib


def built_path() -> Path:
    """Where a build puts the library, named by a hash of the source, so an
    edited source is rebuilt."""
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libpng_decode-{digest}.so"


def _build() -> Path:
    """Compiles the decoder into ``built_path()`` (through a temporary
    name)."""
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        raise OSError("no C++ compiler to build the PNG decoder")
    out = built_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(
        [cxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-o", str(tmp),
         str(SOURCE), "-lz"], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise OSError(f"building the PNG decoder failed:\n{proc.stdout}")
    os.replace(tmp, out)
    return out


def _load():
    """The library (committed, else built here), or None with the reason
    in ``_state["error"]``; loaded once."""
    with _lock:
        if "lib" not in _state:
            _state["lib"], errors = None, []
            for path in (COMMITTED, "built", None):
                try:
                    path = (built_path() if path == "built" else
                            path or _build())
                    if path.exists():
                        _state["lib"] = _declare(ctypes.CDLL(str(path)))
                        _state["path"] = str(path)
                        break
                except OSError as e:
                    errors.append(f"{path}: {e}")
            _state["error"] = "; ".join(errors)
        return _state["lib"]


def available() -> bool:
    return _load() is not None


def library() -> str | None:
    """The path of the loaded library, or None."""
    return _state.get("path") if available() else None


def decode_png(path: str) -> np.ndarray:
    """Decodes a PNG: (H, W) for one channel, else (H, W, C); uint8 or
    uint16 (native byte order). Raises FileNotFoundError for a missing
    file and ValueError for what the decoder does not take (palette,
    interlaced); RuntimeError when no library loads."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"the native PNG decoder does not load: "
                           f"{_state['error']}")
    data = ctypes.c_void_p()
    h, w, ch, depth = (ctypes.c_uint32() for _ in range(4))
    rc = lib.cnt_png_decode(os.fsencode(path), ctypes.byref(data),
                            ctypes.byref(h), ctypes.byref(w),
                            ctypes.byref(ch), ctypes.byref(depth))
    if rc != 0:
        msg = lib.cnt_png_error(rc).decode()
        if rc == 1:
            raise FileNotFoundError(f"{path}: {msg}")
        raise ValueError(f"{path}: {msg}")
    try:
        dtype = np.uint8 if depth.value == 8 else np.uint16
        count = h.value * w.value * ch.value
        buf = (ctypes.c_uint8 * (count * np.dtype(dtype).itemsize)
               ).from_address(data.value)
        out = np.frombuffer(buf, dtype=dtype, count=count).reshape(
            h.value, w.value, ch.value).copy()
    finally:
        lib.cnt_png_free(data)
    return out[..., 0] if out.shape[-1] == 1 else out

"""The C++ runner's PNG path against the port's Python path: the runner
compiles native/dataload/png_decode.cc in and feeds cnt_png_to_input's
normalised frames to the package, where the Python path decodes with
data/io, normalises with encodings.preprocess_image and casts to the
manifest dtype. The decoder is built here with g++ as data/native_io.py
builds it; the two paths must give the same bits (both compute
(x / 255 - mean) / std in float32, then round to nearest even). And the
port's preprocess_image stays within float32 rounding of the JAX
package's (a few ulps: XLA multiplies by reciprocals where torch
divides)."""

import ctypes

import numpy as np
import pytest
import torch

from cerberusnet_torch.data import encodings
from cerberusnet_torch.data import io as data_io
from cerberusnet_torch.data import native_io
from cerberusnet_torch.testing import one_torch_thread  # noqa: F401
from cerberusnet_tpu.data import encodings as jax_encodings

HW = (37, 50)


@pytest.fixture(scope="module")
def decoder():
    """png_decode.cc built from its source (a build named by its hash is
    reused)."""
    path = native_io.built_path()
    if not path.exists():
        path = native_io._build()
    lib = ctypes.CDLL(str(path))
    lib.cnt_png_to_input.restype = ctypes.c_int
    lib.cnt_png_to_input.argtypes = [ctypes.c_char_p, ctypes.c_uint32,
                                     ctypes.c_uint32, ctypes.c_int,
                                     ctypes.c_void_p]
    return lib


def images():
    rng = np.random.RandomState(0)
    rgb = rng.randint(0, 256, (*HW, 3), np.uint8)
    rgb[0, :4] = [[0, 0, 0], [255, 255, 255], [1, 254, 128], [127, 128, 129]]
    return {"rgb": rgb, "gray": rng.randint(0, 256, HW, np.uint8)}


def native_input(lib, path, dtype):
    out = torch.empty((1, *HW, 3), dtype=dtype)
    rc = lib.cnt_png_to_input(str(path).encode(), HW[0], HW[1],
                              int(dtype == torch.bfloat16), out.data_ptr())
    assert rc == 0
    return out


@pytest.mark.parametrize("kind", ["rgb", "gray"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_native_png_input_equals_the_python_path(decoder, tmp_path, kind,
                                                 dtype):
    path = tmp_path / f"{kind}.png"
    data_io.write_image_u8(str(path), images()[kind])
    python = encodings.preprocess_image(
        torch.from_numpy(data_io.read_image_u8(str(path)))[None]).to(dtype)
    native = native_input(decoder, path, dtype)
    assert torch.equal(native.view(torch.int16 if dtype == torch.bfloat16
                                   else torch.int32),
                       python.view(torch.int16 if dtype == torch.bfloat16
                                   else torch.int32))


def test_native_png_input_refuses_another_size(decoder, tmp_path):
    path = tmp_path / "rgb.png"
    data_io.write_image_u8(str(path), images()["rgb"])
    out = torch.empty((1, HW[0] + 1, HW[1], 3))
    assert decoder.cnt_png_to_input(str(path).encode(), HW[0] + 1, HW[1], 0,
                                    out.data_ptr()) != 0


def test_preprocess_image_against_jax():
    img = images()["rgb"][None]
    got = encodings.preprocess_image(torch.from_numpy(img)).numpy()
    want = np.asarray(jax_encodings.preprocess_image(img))
    # float32 rounding: XLA divides by 255 and by std as products with
    # their reciprocals, so values within [-2.2, 2.7] land up to a few ulps
    # (2.4e-7 each) apart
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)

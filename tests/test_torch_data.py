"""The port's data pipeline (cerberusnet_torch.data) against the JAX
package's, on the CPU.

* The KITTI and Cityscapes codecs equal the reference's on the same
  arrays, and round-trip.
* PNGs that OpenCV writes (the JAX package's writer) with each of libpng's
  row filters (none, sub, up, average, Paeth, and its adaptive choice), in
  8-bit RGB and gray and 16-bit RGB and gray: the port's zlib reader
  (``visualization.read_png``, the fallback), its native decoder and
  ``data/io.py``'s readers return what the JAX package's readers return,
  exactly; the port's writer's files read the same in OpenCV. ``.flo``
  and ``.pfm`` files written by either package read the same in both.
* The KITTI and Cityscapes datasets, sample for sample, against the
  reference's on the same fixture files (the reference's writer and the
  port's): every array equal; each sample names the native decoder.
* ``preprocess`` against ``make_preprocess_fn`` at a downscale, an upscale
  and the same size: images within 1e-5, the nearest-resized labels,
  flow, disparity and masks exactly, with their value scaling.
* The threaded ``DataLoader`` yields the reference's order (its
  ``DataLoader``'s, and the synchronous rule) over two epochs, with and
  without shuffle and with a partial last batch; a consumer that leaves
  early stops the producer and its workers; a worker's error reaches the
  consumer.
"""

import threading
import time
import zlib

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cerberusnet_tpu.data import encodings as jenc
from cerberusnet_tpu.data import io as jio
from cerberusnet_tpu.data.cityscapes import (
    CityscapesDataset as JaxCityscapes,
)
from cerberusnet_tpu.data.kitti import Kitti2015Dataset as JaxKitti
from cerberusnet_tpu.data.loader import DataLoader as JaxDataLoader
from cerberusnet_tpu.data.loader import make_preprocess_fn
from cerberusnet_tpu.data.synthetic import (
    SyntheticPerceptionDataset as JaxSynthetic,
)
from cerberusnet_torch.data import encodings as tenc
from cerberusnet_torch.data import io as tio
from cerberusnet_torch.data import native_io
from cerberusnet_torch.data.cityscapes import CityscapesDataset
from cerberusnet_torch.data.kitti import Kitti2015Dataset
from cerberusnet_torch.data.loader import DataLoader, collate, preprocess
from cerberusnet_torch.data.synthetic import SyntheticPerceptionDataset
from cerberusnet_torch.testing import one_torch_thread  # noqa: F401
from cerberusnet_torch.utils import visualization as vis

# ---------------------------------------------------------------- codecs


def test_codecs_match_jax_and_round_trip():
    rng = np.random.RandomState(0)
    flow = (rng.randn(9, 13, 2) * 30).astype(np.float32)
    valid = (rng.rand(9, 13) > 0.4).astype(np.float32)
    png = tenc.encode_kitti_flow(flow, valid)
    np.testing.assert_array_equal(png, jenc.encode_kitti_flow(flow, valid))
    for got, want in zip(tenc.decode_kitti_flow(png),
                         jenc.decode_kitti_flow(png)):
        np.testing.assert_array_equal(got, want)
    dec, dec_valid = tenc.decode_kitti_flow(png)
    np.testing.assert_array_equal(dec_valid, valid)
    np.testing.assert_allclose(dec[valid > 0], flow[valid > 0],
                               atol=1 / 64 + 1e-6)

    disp = (rng.rand(9, 13) * 90).astype(np.float32)
    png = tenc.encode_kitti_disparity(disp, valid)
    np.testing.assert_array_equal(png, jenc.encode_kitti_disparity(disp, valid))
    for got, want in zip(tenc.decode_kitti_disparity(png),
                         jenc.decode_kitti_disparity(png)):
        np.testing.assert_array_equal(got, want)

    labels = rng.randint(0, 256, (9, 13)).astype(np.uint8)
    np.testing.assert_array_equal(tenc.labelids_to_trainids(labels),
                                  jenc.labelids_to_trainids(labels))
    train_ids = np.append(np.arange(19), 255).astype(np.uint8)
    np.testing.assert_array_equal(
        tenc.labelids_to_trainids(tenc.trainids_to_labelids(train_ids)),
        train_ids)

    cs = tenc.encode_cityscapes_disparity(disp, valid)
    for got, want in zip(tenc.decode_cityscapes_disparity(cs),
                         jenc.decode_cityscapes_disparity(cs)):
        np.testing.assert_array_equal(got, np.asarray(want, np.float32))
    back, back_valid = tenc.decode_cityscapes_disparity(cs)
    np.testing.assert_array_equal(back_valid, valid)
    np.testing.assert_allclose(back[valid > 0], disp[valid > 0],
                               atol=0.5 / 256 + 1e-6)


# ------------------------------------------------------------------- PNG

FILTERS = {"none": cv2.IMWRITE_PNG_FILTER_NONE,
           "sub": cv2.IMWRITE_PNG_FILTER_SUB,
           "up": cv2.IMWRITE_PNG_FILTER_UP,
           "average": cv2.IMWRITE_PNG_FILTER_AVG,
           "paeth": cv2.IMWRITE_PNG_FILTER_PAETH,
           "adaptive": cv2.IMWRITE_PNG_ALL_FILTERS}
FILTER_BYTE = {"none": 0, "sub": 1, "up": 2, "average": 3, "paeth": 4}
KINDS = {"rgb8": ((23, 37, 3), np.uint8), "gray8": ((23, 37), np.uint8),
         "rgb16": ((23, 37, 3), np.uint16), "gray16": ((23, 37), np.uint16)}


def smooth_image(shape, dtype, seed=0):
    """Smooth ramps plus noise, so every filter has something to predict."""
    rng = np.random.RandomState(seed)
    top = 255 if dtype == np.uint8 else 65535
    y, x = np.mgrid[:shape[0], :shape[1]].astype(np.float64)
    base = (x / shape[1] + y / shape[0]) / 2
    if len(shape) == 3:
        base = base[..., None] * np.linspace(0.5, 1.0, shape[2])
    img = base * top * 0.9 + rng.rand(*shape) * top * 0.1
    return img.astype(dtype)


def row_filters(path):
    """The filter byte of each row of a (non-interlaced) PNG file."""
    with open(path, "rb") as f:
        data = f.read()
    pos, idat, header = 8, b"", None
    while pos < len(data):
        n = int.from_bytes(data[pos:pos + 4], "big")
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if kind == b"IHDR":
            header = body
        elif kind == b"IDAT":
            idat += body
        pos += 12 + n
    w, h = int.from_bytes(header[:4], "big"), int.from_bytes(header[4:8], "big")
    depth, color = header[8], header[9]
    rowbytes = w * {0: 1, 2: 3, 4: 2, 6: 4}[color] * depth // 8
    raw = zlib.decompress(idat)
    return {raw[y * (rowbytes + 1)] for y in range(h)}


def cv2_write(path, img, flt):
    bgr = img[..., ::-1] if img.ndim == 3 else img
    assert cv2.imwrite(str(path), np.ascontiguousarray(bgr),
                       [cv2.IMWRITE_PNG_FILTER, FILTERS[flt]])
    return str(path)


@pytest.mark.parametrize("flt", list(FILTERS))
@pytest.mark.parametrize("kind", list(KINDS))
def test_png_readers_match_jax_on_cv2_files(tmp_path, kind, flt):
    shape, dtype = KINDS[kind]
    img = smooth_image(shape, dtype)
    path = cv2_write(tmp_path / "x.png", img, flt)
    used = row_filters(path)
    if flt in FILTER_BYTE:
        assert used == {FILTER_BYTE[flt]}, used
    else:  # libpng's adaptive choice: more than one filter in the file
        assert len(used) > 1, used
    np.testing.assert_array_equal(vis.read_png(path), img)
    np.testing.assert_array_equal(native_io.decode_png(path), img)
    if dtype == np.uint16:
        np.testing.assert_array_equal(tio.read_png16(path), jio.read_png16(path))
    elif kind == "gray8":
        np.testing.assert_array_equal(tio.read_image_gray_u8(path),
                                      jio.read_image_gray_u8(path))
    np.testing.assert_array_equal(
        tio.read_image_u8(path) if dtype == np.uint8 else img,
        jio.read_image_u8(path) if dtype == np.uint8 else img)


@pytest.mark.parametrize("kind", list(KINDS))
def test_port_png_writer_reads_back_in_opencv(tmp_path, kind):
    shape, dtype = KINDS[kind]
    img = smooth_image(shape, dtype, seed=1)
    path = str(tmp_path / "y.png")
    (tio.write_png16 if dtype == np.uint16 else tio.write_image_u8)(path, img)
    back = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    np.testing.assert_array_equal(back[..., ::-1] if img.ndim == 3 else back,
                                  img)
    decoded = []
    got = (tio.read_png16 if dtype == np.uint16 else
           tio.read_image_u8 if img.ndim == 3 else tio.read_image_gray_u8)(
               path, decoded)
    np.testing.assert_array_equal(got, img)
    assert decoded == ["native"]


def test_png_fallbacks(tmp_path):
    """A palette PNG: the native decoder and the zlib reader refuse it, as
    the reference's native decoder does (the reference's OpenCV then reads
    it; the port raises). A bad CRC and a missing file raise."""
    path = str(tmp_path / "p.png")
    img = np.zeros((4, 5, 3), np.uint8)
    img[1, 2] = (255, 0, 0)
    from PIL import Image  # only here: the port needs no PIL
    Image.fromarray(img).convert("P").save(path)
    with pytest.raises(ValueError):
        native_io.decode_png(path)
    with pytest.raises(ValueError, match="gray/RGB"):
        tio.read_image_u8(path)
    good = vis.write_png(str(tmp_path / "g.png"), img)
    data = bytearray(open(good, "rb").read())
    data[-20] ^= 0xFF
    open(good, "wb").write(bytes(data))
    with pytest.raises(ValueError, match="CRC"):
        vis.read_png(good)
    with pytest.raises(FileNotFoundError):
        tio.read_image_u8(str(tmp_path / "missing.png"))


def test_flo_and_pfm_match_jax(tmp_path):
    rng = np.random.RandomState(2)
    flow = rng.randn(7, 11, 2).astype(np.float32)
    for write, read in ((tio.write_flo, jio.read_flo),
                        (jio.write_flo, tio.read_flo)):
        write(str(tmp_path / "a.flo"), flow)
        np.testing.assert_array_equal(read(str(tmp_path / "a.flo")), flow)
    for img in (rng.randn(7, 11).astype(np.float32),
                rng.randn(7, 11, 3).astype(np.float32)):
        for write, read in ((tio.write_pfm, jio.read_pfm),
                            (jio.write_pfm, tio.read_pfm)):
            write(str(tmp_path / "a.pfm"), img)
            np.testing.assert_array_equal(read(str(tmp_path / "a.pfm")), img)
    with pytest.raises(IOError):
        tio.read_flo(str(tmp_path / "a.pfm"))


# -------------------------------------------------------------- datasets


def assert_same_samples(port_ds, jax_ds):
    assert len(port_ds) == len(jax_ds) > 0
    for i in range(len(jax_ds)):
        got, want = port_ds[i], jax_ds[i]
        assert got.pop("decoder") == "native"
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == np.asarray(want[k]).dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_kitti_dataset_matches_jax(tmp_path, writer):
    hw = (37, 61)
    synth = (JaxSynthetic if writer == "jax" else SyntheticPerceptionDataset)(
        length=3, hw=hw, sparse=True, seed=2)
    synth.write_kitti_fixture(str(tmp_path / "training"), 3)
    assert_same_samples(Kitti2015Dataset(str(tmp_path), "training"),
                        JaxKitti(str(tmp_path), "training"))
    # a root that holds image_2/ itself
    assert len(Kitti2015Dataset(str(tmp_path / "training"), "")) == 3
    with pytest.raises(FileNotFoundError):
        Kitti2015Dataset(str(tmp_path / "nowhere"))


def test_cityscapes_dataset_matches_jax(tmp_path):
    synth = SyntheticPerceptionDataset(length=3, hw=(40, 72), seed=3)
    for split in ("train", "val"):
        synth.write_cityscapes_fixture(str(tmp_path), 3 if split == "train"
                                       else 2, split)
    for split, n in (("train", 3), ("val", 2)):
        ds = CityscapesDataset(str(tmp_path), split)
        assert len(ds) == n
        assert_same_samples(ds, JaxCityscapes(str(tmp_path), split))
    s = CityscapesDataset(str(tmp_path), "train")[1]
    np.testing.assert_array_equal(s["temporal"], s["left"])
    np.testing.assert_array_equal(s["seg_labels"], synth[1]["seg_labels"])
    with pytest.raises(FileNotFoundError):
        CityscapesDataset(str(tmp_path), "test")


# ------------------------------------------------------------ preprocess


@pytest.mark.parametrize("out_hw", [(16, 24), (80, 128), (37, 61)],
                         ids=["down", "up", "same"])
def test_preprocess_matches_make_preprocess_fn(out_hw):
    synth = JaxSynthetic(length=2, hw=(37, 61), sparse=True, seed=4)
    batch = collate([synth[0], synth[1]])
    want = make_preprocess_fn(out_hw=out_hw)(
        {k: jnp.asarray(v) for k, v in batch.items()})
    got = preprocess(batch, out_hw, torch.float32, "cpu")
    assert sorted(got) == sorted(want)
    for k in ("left", "right", "temporal"):
        assert got[k].shape == (2, *out_hw, 3)
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=1e-5, err_msg=k)
    assert got["seg_labels"].dtype == torch.int64
    for k in ("seg_labels", "flow_gt", "flow_valid", "disp_gt", "disp_valid"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    # bf16 images are the float32 ones rounded
    got16 = preprocess(batch, out_hw, torch.bfloat16, "cpu")
    assert torch.equal(got16["left"], got["left"].bfloat16())


def test_resize_nearest_takes_jax_source_indices():
    import jax

    x = np.arange(7 * 13, dtype=np.float32).reshape(1, 7, 13, 1)
    for hw in ((3, 5), (10, 29), (7, 13), (375 // 25, 1242 // 25)):
        want = jax.image.resize(jnp.asarray(x), (1, *hw, 1), "nearest")
        got = tenc.resize_nearest(torch.from_numpy(x), hw)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------- loader


class CountingDataset:
    """Samples that name their index; counts __getitem__ calls, and sleeps
    a little so the producer runs ahead of the consumer."""

    def __init__(self, n, fail_at=None):
        self.n, self.calls, self.fail_at = n, 0, fail_at
        self.lock = threading.Lock()

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        with self.lock:
            self.calls += 1
        if i == self.fail_at:
            raise OSError(f"sample {i} is unreadable")
        time.sleep(0.002)
        return {"idx": np.int64(i), "x": np.full((2, 3), i, np.float32)}


def sync_order(n, bs, shuffle, seed, epoch, drop_last):
    idx = np.arange(n)
    if shuffle:
        np.random.RandomState(seed + epoch).shuffle(idx)
    nb = n // bs if drop_last else -(-n // bs)
    return [list(idx[i * bs:(i + 1) * bs]) for i in range(nb)]


@pytest.mark.parametrize("drop_last", [True, False])
@pytest.mark.parametrize("shuffle", [False, True])
def test_threaded_loader_yields_the_reference_order(shuffle, drop_last):
    n, bs, seed = 23, 4, 7
    ds = CountingDataset(n)
    loader = DataLoader(ds, bs, shuffle=shuffle, num_workers=3, seed=seed,
                        drop_last=drop_last, prefetch=2)
    ref = JaxDataLoader(ds, bs, shuffle=shuffle, num_workers=3, seed=seed,
                        drop_last=drop_last)
    for epoch in (1, 2):
        got = [list(b["idx"]) for b in loader]
        assert got == [list(b["idx"]) for b in ref]
        assert got == sync_order(n, bs, shuffle, seed, epoch, drop_last)
        assert len(got) == len(loader)


def test_loader_stops_its_producer_when_the_consumer_leaves():
    ds = CountingDataset(400)
    before = set(threading.enumerate())
    loader = DataLoader(ds, 4, num_workers=2, prefetch=2)
    it = iter(loader)
    first = next(it)
    assert list(first["idx"]) == [0, 1, 2, 3]
    started = set(threading.enumerate()) - before
    assert len(started) >= 2  # the producer and its workers
    it.close()  # the consumer leaves: close() joins them
    assert not any(t.is_alive() for t in started)
    # the batch taken, the queue's two and the one being decoded at most
    assert ds.calls <= 4 * 4, ds.calls
    calls = ds.calls
    time.sleep(0.05)
    assert ds.calls == calls


def test_loader_raises_a_worker_error_in_the_consumer():
    loader = DataLoader(CountingDataset(12, fail_at=9), 4, num_workers=2)
    got = []
    with pytest.raises(OSError, match="sample 9"):
        for b in loader:
            got.append(list(b["idx"]))
    assert got == [[0, 1, 2, 3], [4, 5, 6, 7]]

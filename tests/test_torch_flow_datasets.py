"""The port's Sintel, FlyingChairs and FlyingThings3D datasets
(cerberusnet_torch/data/flow_datasets.py) and its PPM/PGM reader, against
the JAX package and OpenCV, on the CPU.

* PPM and PGM files OpenCV writes read back equal to ``cv2.imread``'s
  (RGB), and the port's PPM and PGM files read back equal in OpenCV.
* On fixture trees written here from a seed, each dataset's samples equal
  the JAX dataset's: the same keys, types and values. Sintel pairs only
  consecutive frames and masks its invalid pixels; FlyingChairs reads its
  split file by id and raises on a file too short; FlyingThings3D maps
  DataConfig's split names onto TRAIN and TEST and masks non-finite and
  out-of-range flow and disparity (zeroed, not clipped).
* A tiny flow Trainer fits one epoch on a Sintel fixture.
"""

import os

import cv2
import numpy as np
import pytest

from cerberusnet_torch.data import io as data_io
from cerberusnet_torch.data.flow_datasets import (
    FlyingChairsDataset,
    FlyingThings3DDataset,
    SintelDataset,
)
from cerberusnet_torch.testing import one_torch_thread  # noqa: F401
from cerberusnet_tpu.data import flow_datasets as jax_fd

HW = (12, 16)


def _img(rng, hw=HW):
    return rng.randint(0, 256, (*hw, 3)).astype(np.uint8)


# ------------------------------------------------------------- PPM/PGM


@pytest.mark.parametrize("shape", [(5, 7, 3), (9, 4, 3), (6, 11)])
def test_pnm_reads_as_opencv(tmp_path, shape):
    rng = np.random.RandomState(len(shape))
    img = rng.randint(0, 256, shape).astype(np.uint8)
    path = str(tmp_path / ("a.ppm" if len(shape) == 3 else "a.pgm"))
    assert cv2.imwrite(path, img[..., ::-1] if img.ndim == 3 else img)
    want = cv2.cvtColor(cv2.imread(path, cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)
    np.testing.assert_array_equal(data_io.read_image_u8(path), want)
    if img.ndim == 2:
        np.testing.assert_array_equal(
            data_io.read_image_gray_u8(path),
            cv2.imread(path, cv2.IMREAD_GRAYSCALE))
    else:
        np.testing.assert_array_equal(data_io.read_image_u8(path), img)


def test_pnm_header_comments_and_port_writer(tmp_path):
    img = np.random.RandomState(3).randint(0, 256, (4, 6, 3)).astype(np.uint8)
    path = tmp_path / "c.ppm"
    path.write_bytes(b"P6\n# a comment\n6 4\n# another\n255\n" + img.tobytes())
    np.testing.assert_array_equal(data_io.read_image_u8(str(path)), img)
    used = []
    data_io.read_image_u8(str(path), used)
    assert used == ["pnm"]
    for name, arr in (("w.ppm", img), ("w.pgm", img[..., 1])):
        data_io.write_image_u8(str(tmp_path / name), arr)
        got = cv2.imread(str(tmp_path / name), cv2.IMREAD_UNCHANGED)
        np.testing.assert_array_equal(
            got[..., ::-1] if arr.ndim == 3 else got, arr)


def test_pnm_refuses_other_formats(tmp_path):
    path = tmp_path / "p3.ppm"
    path.write_bytes(b"P3\n1 1\n255\n1 2 3\n")
    with pytest.raises(ValueError, match="PPM or PGM"):
        data_io.read_image_u8(str(path))
    path.write_bytes(b"P6\n1 1\n65535\n" + bytes(6))
    with pytest.raises(ValueError, match="maxval"):
        data_io.read_image_u8(str(path))


# ------------------------------------------------------------- fixtures


def make_sintel(root, frames=(1, 2, 3), scenes=("alley_1", "cave_2"),
                seed=0):
    """Sintel's layout; frames missing from ``frames`` leave a gap."""
    rng = np.random.RandomState(seed)
    for scene in scenes:
        for kind in ("clean", "flow", "invalid"):
            os.makedirs(os.path.join(root, "training", kind, scene))
        for t in frames:
            data_io.write_image_u8(os.path.join(
                root, "training", "clean", scene, f"frame_{t:04d}.png"),
                _img(rng))
            flow = rng.normal(scale=4.0, size=(*HW, 2)).astype(np.float32)
            data_io.write_flo(os.path.join(
                root, "training", "flow", scene, f"frame_{t:04d}.flo"), flow)
            inv = (rng.rand(*HW) < 0.2).astype(np.uint8) * 255
            data_io.write_image_u8(os.path.join(
                root, "training", "invalid", scene, f"frame_{t:04d}.png"), inv)


def make_chairs(root, n=4, seed=0):
    rng = np.random.RandomState(seed)
    os.makedirs(os.path.join(root, "data"))
    for i in range(1, n + 1):
        base = os.path.join(root, "data", f"{i:05d}")
        data_io.write_image_u8(base + "_img1.ppm", _img(rng))
        data_io.write_image_u8(base + "_img2.ppm", _img(rng))
        data_io.write_flo(base + "_flow.flo", rng.normal(
            scale=3.0, size=(*HW, 2)).astype(np.float32))


def make_things(root, split="TRAIN", seed=0):
    """FlyingThings3D's layout: sequences A/0000 (frames 6, 7, 8) and
    B/0001 (frames 3, 5: no pair), flow with inf, NaN and >= 1000 values,
    disparity with negative, inf and >= 1000 values."""
    rng = np.random.RandomState(seed)
    for subset, seq, frames in (("A", "0000", (6, 7, 8)), ("B", "0001", (3, 5))):
        for cam in ("left", "right"):
            d = os.path.join(root, "frames_cleanpass", split, subset, seq, cam)
            os.makedirs(d)
            for t in frames:
                data_io.write_image_u8(os.path.join(d, f"{t:04d}.png"),
                                       _img(rng))
        fd = os.path.join(root, "optical_flow", split, subset, seq,
                          "into_future", "left")
        dd = os.path.join(root, "disparity", split, subset, seq, "left")
        os.makedirs(fd)
        os.makedirs(dd)
        for t in frames:
            flow = rng.normal(scale=20.0, size=(*HW, 3)).astype(np.float32)
            flow[0, 0, 0] = np.inf
            flow[0, 1, 1] = np.nan
            flow[1, 0, 0] = 1000.0
            flow[1, 1, 1] = -1500.0
            flow[2, 2, 2] = np.inf  # the unused channel: no effect
            data_io.write_pfm(os.path.join(
                fd, f"OpticalFlowIntoFuture_{t:04d}_L.pfm"), flow)
            disp = rng.uniform(0.5, 90.0, HW).astype(np.float32)
            disp[0, 0], disp[0, 1], disp[0, 2] = -4.0, np.inf, 1000.0
            disp[0, 3] = 0.0
            data_io.write_pfm(os.path.join(dd, f"{t:04d}.pfm"), disp)


def assert_same_samples(port_ds, jax_ds):
    assert len(port_ds) == len(jax_ds)
    for i in range(len(jax_ds)):
        got, want = port_ds[i], jax_ds[i]
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            assert got[k].shape == want[k].shape, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# -------------------------------------------------------------- Sintel


def test_sintel_samples_equal_jax(tmp_path):
    make_sintel(str(tmp_path), frames=(1, 2, 3, 5, 6))
    ds = SintelDataset(str(tmp_path), render_pass="clean")
    # frames 1-2, 2-3, 5-6 in each scene: 3 -> 5 is a gap
    assert ds.pairs == [(s, t) for s in ("alley_1", "cave_2")
                        for t in (1, 2, 5)]
    assert_same_samples(ds, jax_fd.SintelDataset(str(tmp_path)))
    s = ds[0]
    assert 0 < s["flow_valid"].mean() < 1
    inv = data_io.read_image_gray_u8(str(
        tmp_path / "training" / "invalid" / "alley_1" / "frame_0001.png"))
    np.testing.assert_array_equal(s["flow_valid"], (inv == 0).astype(
        np.float32))


def test_sintel_without_flow_or_invalid(tmp_path):
    make_sintel(str(tmp_path), scenes=("market_5",))
    os.remove(tmp_path / "training" / "invalid" / "market_5" /
              "frame_0001.png")
    os.remove(tmp_path / "training" / "flow" / "market_5" / "frame_0002.flo")
    ds = SintelDataset(str(tmp_path))
    assert_same_samples(ds, jax_fd.SintelDataset(str(tmp_path)))
    assert ds[0]["flow_valid"].all()
    assert sorted(ds[1]) == ["left", "temporal"]


def test_sintel_missing_pass_raises_in_both(tmp_path):
    make_sintel(str(tmp_path))
    for cls in (SintelDataset, jax_fd.SintelDataset):
        with pytest.raises(FileNotFoundError, match="final"):
            cls(str(tmp_path), render_pass="final")


# --------------------------------------------------------- FlyingChairs


@pytest.mark.parametrize("split", ["train", "training", "val"])
def test_chairs_split_file_by_id_equals_jax(tmp_path, split):
    make_chairs(str(tmp_path))
    # id 2 has no files: id 3's flag must still be row 3's
    for suffix in ("img1.ppm", "img2.ppm", "flow.flo"):
        os.remove(tmp_path / "data" / f"00002_{suffix}")
    (tmp_path / "FlyingChairs_train_val.txt").write_text("1\n2\n2\n1\n")
    ds = FlyingChairsDataset(str(tmp_path), split=split)
    want = ["00004", "00001"] if split != "val" else ["00003"]
    assert sorted(ds.ids) == sorted(want)
    assert_same_samples(ds, jax_fd.FlyingChairsDataset(str(tmp_path), split))


def test_chairs_without_split_file_reads_every_id(tmp_path):
    make_chairs(str(tmp_path / "flat"), n=3)
    root = str(tmp_path / "flat" / "data")  # the flat directory itself
    ds = FlyingChairsDataset(root)
    assert ds.ids == ["00001", "00002", "00003"]
    assert_same_samples(ds, jax_fd.FlyingChairsDataset(root))
    assert ds[0]["left"].shape == (*HW, 3) and ds[0]["flow_valid"].all()


def test_chairs_split_file_too_short_raises_in_both(tmp_path):
    make_chairs(str(tmp_path))
    (tmp_path / "FlyingChairs_train_val.txt").write_text("1\n1\n2\n")
    errors = []
    for cls in (FlyingChairsDataset, jax_fd.FlyingChairsDataset):
        with pytest.raises(ValueError) as e:
            cls(str(tmp_path), split="train")
        errors.append(str(e.value))
    assert errors[0] == errors[1]
    assert "outside split file (3 rows)" in errors[0]


# ------------------------------------------------------- FlyingThings3D


@pytest.mark.parametrize("split,folder", [
    ("training", "TRAIN"), ("train", "TRAIN"), ("TRAIN", "TRAIN"),
    ("val", "TEST"), ("validation", "TEST"), ("test", "TEST")])
def test_things_split_names_equal_jax(tmp_path, split, folder):
    make_things(str(tmp_path), folder)
    ds = FlyingThings3DDataset(str(tmp_path), split)
    assert ds.split == folder
    assert ds.pairs == [("A", "0000", 6), ("A", "0000", 7)]
    assert_same_samples(ds, jax_fd.FlyingThings3DDataset(str(tmp_path), split))


def test_things_masks_bad_ground_truth(tmp_path):
    make_things(str(tmp_path))
    s = FlyingThings3DDataset(str(tmp_path), "training")[0]
    for y, x in ((0, 0), (0, 1), (1, 0), (1, 1)):
        assert s["flow_valid"][y, x] == 0 and not s["flow_gt"][y, x].any()
    assert s["flow_valid"][2, 2] == 1  # the third channel is dropped
    assert np.isfinite(s["flow_gt"]).all()
    assert (s["disp_valid"][0, :4] == 0).all()
    assert not s["disp_gt"][0, :4].any() and np.isfinite(s["disp_gt"]).all()
    assert s["disp_valid"][1:].all()


def test_things_missing_split_raises_in_both(tmp_path):
    make_things(str(tmp_path))
    for cls in (FlyingThings3DDataset, jax_fd.FlyingThings3DDataset):
        with pytest.raises(FileNotFoundError, match="TEST"):
            cls(str(tmp_path), "val")


# ------------------------------------------------------------- trainer


def test_flow_trainer_fits_on_a_sintel_fixture(tmp_path):
    from cerberusnet_torch.train.config import ExperimentConfig
    from cerberusnet_torch.train.trainer import Trainer

    make_sintel(str(tmp_path))
    cfg = ExperimentConfig.from_dict({
        "name": "sintel-fixture",
        "model": {"variant": "flow", "encoder_channels": [8, 12, 16, 16, 16, 16],
                  "est_channels": [16, 16, 12], "ctx_channels": [16, 16]},
        "data": {"dataset": "sintel", "root": str(tmp_path), "hw": [64, 64],
                 "batch_size": 2, "num_workers": 1, "shuffle": False},
        "optim": {"lr": 1e-3, "warmup_steps": 0, "total_steps": 10,
                  "schedule": "constant"},
        "train": {"epochs": 1, "log_every": 1000}})
    cfg.check_supported()
    tr = Trainer(cfg, device="cpu")
    assert isinstance(tr.dataset, SintelDataset) and len(tr.dataset) == 4
    history = tr.fit()
    assert tr.step == 2
    row = history[-1]
    assert sorted(k for k in row if k.startswith("loss_")) == [
        "loss_flow", "loss_total"]
    assert all(np.isfinite(row[k]) for k in ("loss_flow", "loss_total"))

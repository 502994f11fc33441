"""The port's benchmark-submission writers (cerberusnet_torch/eval/
submission.py) and ``Trainer.predict_to_dir`` / ``predict_images``, against
the JAX package on the CPU.

* The trainId -> labelId table is the reference's and the inverse of the
  dataset's map; written files decode back through the datasets' decoders
  to the predictions within the formats' codes (flow 1/64 px, disparity
  1/256 px), labels exact, the ignore trainId as labelId 0.
* ``_to_native`` (``F.interpolate`` in place of OpenCV): the files the
  port writes at a native size decode within one code of the files the
  JAX writer (OpenCV) writes from the same predictions, labels equal, on
  shrinks and enlargements.
* ``predict_to_dir`` on a KITTI fixture (70x140 frames, 64x128 working
  size, 3 samples at batch 2: the padded row dropped) and
  ``predict_images`` on three PNGs: the same files as the JAX Trainer's on
  the same weights, decoded within one code, labels equal, the npz arrays
  within 1e-4 of max(max|JAX|, 1).
"""

import os

import cv2
import jax
import numpy as np
import pytest
import torch

from cerberusnet_torch.data.encodings import (
    CITYSCAPES_LABELID_TO_TRAINID,
    decode_kitti_disparity,
    decode_kitti_flow,
)
from cerberusnet_torch.data.io import (
    read_image_gray_u8,
    read_png16,
    write_image_u8,
)
from cerberusnet_torch.data.synthetic import SyntheticPerceptionDataset
from cerberusnet_torch.eval import submission
from cerberusnet_torch.testing import one_torch_thread  # noqa: F401
from cerberusnet_torch.train.config import ExperimentConfig
from cerberusnet_torch.train.trainer import Trainer
from cerberusnet_tpu.eval import submission as jax_submission
from tests.jax_pairs import draw_params, numpy_tree, port_masters

FLOW_CODE, DISP_CODE = 1.0 / 64, 1.0 / 256


def outputs(b, h, w, seed=7):
    rng = np.random.RandomState(seed)
    return {"flow": rng.uniform(-30, 30, (b, h, w, 2)).astype(np.float32),
            "disp": rng.uniform(0.5, 90, (b, h, w, 1)).astype(np.float32),
            "seg_logits": rng.randn(b, h, w, 19).astype(np.float32)}


def decoded(out_dir, stem):
    """(flow, flow valid, disparity, disparity valid, labelIds) of one
    frame's files."""
    flow, fv = decode_kitti_flow(read_png16(
        os.path.join(out_dir, "flow", f"{stem}.png")))
    disp, dv = decode_kitti_disparity(read_png16(
        os.path.join(out_dir, "disp_0", f"{stem}.png")))
    labels = read_image_gray_u8(os.path.join(out_dir, "semantic",
                                             f"{stem}.png"))
    return flow, fv, disp, dv, labels


def assert_files_agree(got_dir, want_dir, stem):
    got, want = decoded(got_dir, stem), decoded(want_dir, stem)
    for a, b in zip(got, want):
        assert a.shape == b.shape
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=FLOW_CODE + 1e-6)
    np.testing.assert_allclose(got[2], want[2], rtol=0, atol=DISP_CODE + 1e-6)
    for i in (1, 3, 4):
        np.testing.assert_array_equal(got[i], want[i])


def test_trainid_labelid_table():
    np.testing.assert_array_equal(submission.TRAINID_TO_LABELID,
                                  jax_submission.TRAINID_TO_LABELID)
    assert np.all(CITYSCAPES_LABELID_TO_TRAINID[submission.TRAINID_TO_LABELID]
                  == np.arange(19))


def test_write_predictions_round_trip(tmp_path):
    out = outputs(2, 16, 24)
    out["seg_logits"][0, :2, :3] = 0
    names = ["000000_10", "000001_10"]
    made = submission.write_predictions(
        {k: torch.from_numpy(v) for k, v in out.items()}, str(tmp_path), names)
    assert [os.path.relpath(p, tmp_path) for p in made] == [
        f"{d}/{n}.png" for d in ("flow", "disp_0", "semantic") for n in names]
    for i, stem in enumerate(names):
        flow, fv, disp, dv, labels = decoded(str(tmp_path), stem)
        assert fv.min() == 1 and dv.min() == 1
        np.testing.assert_allclose(flow, out["flow"][i], atol=FLOW_CODE + 1e-6)
        np.testing.assert_allclose(disp, out["disp"][i, ..., 0],
                                   atol=DISP_CODE + 1e-6)
        np.testing.assert_array_equal(CITYSCAPES_LABELID_TO_TRAINID[labels],
                                      out["seg_logits"][i].argmax(-1))


def test_ignore_trainid_writes_labelid_zero(tmp_path):
    seg = np.array([[0, 5, 18], [255, 3, 255]], np.uint8)
    path = str(tmp_path / "s.png")
    submission.write_seg_png(path, seg)
    np.testing.assert_array_equal(read_image_gray_u8(path),
                                  [[7, 17, 33], [0, 12, 0]])


@pytest.mark.parametrize("hw,native_hw", [
    ((16, 24), (20, 40)), ((96, 160), (40, 70)), ((64, 128), (75, 242)),
    ((8, 16), (16, 64))])
def test_native_resolution_files_agree_with_jax(tmp_path, hw, native_hw):
    out = outputs(1, *hw, seed=hw[0])
    got_dir, want_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    submission.write_predictions(out, got_dir, ["x"], native_hw=native_hw)
    jax_submission.write_predictions(out, want_dir, ["x"],
                                     native_hw=native_hw)
    flow = decoded(got_dir, "x")[0]
    assert flow.shape == (*native_hw, 2)
    assert_files_agree(got_dir, want_dir, "x")


def test_native_resolution_scales_values(tmp_path):
    flow = np.zeros((1, 8, 16, 2), np.float32)
    flow[..., 0], flow[..., 1] = 2.0, 1.0
    seg = np.zeros((1, 8, 16, 19), np.float32)
    seg[..., 5] = 1.0
    out = {"flow": flow, "disp": np.full((1, 8, 16, 1), 3.0, np.float32),
           "seg_logits": seg}
    submission.write_predictions(out, str(tmp_path), ["x"],
                                 native_hw=(16, 64))
    got_flow, _, got_disp, _, labels = decoded(str(tmp_path), "x")
    np.testing.assert_allclose(got_flow[..., 0], 8.0, atol=1 / 32)
    np.testing.assert_allclose(got_flow[..., 1], 2.0, atol=1 / 32)
    np.testing.assert_allclose(got_disp, 12.0, atol=1 / 128)
    assert (labels == 17).all()


# --------------------------------------------------- the trainers' files

TINY = {"variant": "cerberus", "encoder_channels": [8, 12, 16, 16, 16, 16],
        "est_channels": [16, 16, 12], "ctx_channels": [16, 16],
        "fpn_channels": 16, "corr_impl": "pure"}


@pytest.fixture(scope="module")
def trainers(tmp_path_factory):
    """The JAX and the port Trainer of a tiny CerberusNet on a 3-sample
    KITTI fixture (70x140 frames, 64x128 working size, batch 2), the port
    on the JAX trainer's weights."""
    from cerberusnet_tpu.train.config import ExperimentConfig as JaxConfig
    from cerberusnet_tpu.train.trainer import Trainer as JaxTrainer

    root = tmp_path_factory.mktemp("kitti")
    SyntheticPerceptionDataset(length=3, hw=(70, 140), sparse=True
                               ).write_kitti_fixture(str(root / "training"), 3)
    raw = {"name": "tiny-predict", "model": TINY,
           "data": {"dataset": "kitti", "root": str(root), "hw": [64, 128],
                    "batch_size": 2, "num_workers": 1, "shuffle": False},
           "train": {"num_data_devices": 1}}
    jt = JaxTrainer(JaxConfig.from_dict(raw))
    params = draw_params(jax.eval_shape(lambda: jt.state.params), 11)
    jt.state = jt.state.replace(params=jax.tree.map(jax.numpy.asarray, params))
    cfg = ExperimentConfig.from_dict(raw)
    tr = Trainer(cfg, device="cpu")
    tr.load_masters(port_masters(cfg, numpy_tree(params)))
    return jt, tr, root


def test_predict_to_dir_equals_jax(trainers, tmp_path):
    jt, tr, _ = trainers
    want = jt.predict_to_dir(str(tmp_path / "jax"))
    got = tr.predict_to_dir(str(tmp_path / "port"))
    rel = [os.path.relpath(p, tmp_path / "port") for p in got]
    assert rel == [os.path.relpath(p, tmp_path / "jax") for p in want]
    assert len(rel) == 9 and "flow/000002_10.png" in rel
    for i in range(3):
        assert_files_agree(str(tmp_path / "port"), str(tmp_path / "jax"),
                           f"{i:06d}_10")
    assert decoded(str(tmp_path / "port"), "000002_10")[0].shape == (70, 140, 2)


def test_predict_images_equals_jax(trainers, tmp_path):
    jt, tr, root = trainers
    rng = np.random.RandomState(4)
    paths = {}
    for k in ("left", "right", "temporal"):
        paths[k] = str(tmp_path / f"{k}.png")
        write_image_u8(paths[k], rng.randint(0, 256, (70, 140, 3)))
    want = jt.predict_images(paths, str(tmp_path / "jax"), name="frame")
    got = tr.predict_images(paths, str(tmp_path / "port"), name="frame")
    names = [os.path.basename(p) for p in got]
    assert names == [os.path.basename(p) for p in want]
    assert names[0] == "frame.npz" and names[-1] == "frame_panel.png"
    a = np.load(got[0])
    b = np.load(want[0])
    assert sorted(a.files) == sorted(b.files) == ["disp", "flow", "seg_logits"]
    for k in b.files:
        assert a[k].shape == b[k].shape and a[k].dtype == np.float32
        err = np.abs(a[k] - b[k]).max() / max(np.abs(b[k]).max(), 1)
        assert err <= 1e-4, (k, err)
    assert_files_agree(str(tmp_path / "port"), str(tmp_path / "jax"), "frame")
    panel = cv2.imread(got[-1])
    assert panel.shape == cv2.imread(want[-1]).shape
    assert panel.shape[1] == 128  # the image resized to data.hw


def test_predict_images_names_missing_inputs(trainers, tmp_path):
    _, tr, _ = trainers
    with pytest.raises(ValueError, match=r"\['right', 'temporal'\]"):
        tr.predict_images({"left": "l.png"}, str(tmp_path))

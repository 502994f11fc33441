"""The port's TensorBoard writer (cerberusnet_torch.utils.tblogger)
against the JAX package's, on the CPU.

* CRC32C on the RFC 3720 vectors and the TFRecord mask, equal to the
  reference's on random bytes.
* With the clock fixed, the port's file of scalars is the reference's
  byte for byte (the file-version event and every scalar record).
* An image record: every field the reference's but the PNG payload (the
  port encodes with its own writer, the reference with OpenCV), which
  decodes to the same pixels in OpenCV; TensorBoard's own
  ``EventAccumulator`` reads the port's scalars and image.
* ``train.tensorboard`` in the port's ``fit``: loss scalars at
  ``log_every``, each epoch's row and the evaluation panel, readable by
  ``EventAccumulator``.
"""

import json
import os
import struct
import time

import cv2
import numpy as np
import pytest

from cerberusnet_tpu.utils import tblogger as jtb
from cerberusnet_torch.entry import REPO_ROOT
from cerberusnet_torch.testing import one_torch_thread  # noqa: F401
from cerberusnet_torch.train.config import ExperimentConfig
from cerberusnet_torch.train.trainer import Trainer
from cerberusnet_torch.utils import tblogger as ttb
from tensorboard.backend.event_processing.event_accumulator import (
    EventAccumulator,
)

WALL = 1760000000.25


def test_crc32c_matches_vectors_and_jax():
    assert ttb.crc32c(b"") == 0
    assert ttb.crc32c(b"123456789") == 0xE3069283
    assert ttb.crc32c(b"\x00" * 32) == 0x8A9136AA
    assert ttb.crc32c(b"\xff" * 32) == 0x62A8AB43
    data = np.random.RandomState(0).bytes(1000)
    assert ttb.crc32c(data) == jtb.crc32c(data)
    assert ttb._masked_crc(data) == jtb._masked_crc(data)


def write(module, logdir, monkeypatch, image=None):
    monkeypatch.setattr(time, "time", lambda: WALL)
    with module.TBLogger(str(logdir)) as tb:
        for step in range(4):
            tb.scalar("loss/total", 1.0 / (step + 1), step)
        tb.scalars({"miou": 0.5, "flow_epe": 2.0, "note": "text"}, step=7,
                   prefix="eval/")
        if image is not None:
            tb.image("eval/panel", image, step=9)
    return tb.path


def records(path):
    """The payloads of a TFRecord file, each frame's CRCs checked."""
    out = []
    with open(path, "rb") as f:
        data = f.read()
    pos = 0
    while pos < len(data):
        header = data[pos:pos + 8]
        (n,) = struct.unpack("<Q", header)
        assert struct.unpack("<I", data[pos + 8:pos + 12])[0] == (
            jtb._masked_crc(header))
        payload = data[pos + 12:pos + 12 + n]
        assert struct.unpack("<I", data[pos + 12 + n:pos + 16 + n])[0] == (
            jtb._masked_crc(payload))
        out.append(payload)
        pos += 16 + n
    return out


def test_scalar_records_are_the_reference_bytes(tmp_path, monkeypatch):
    port = write(ttb, tmp_path / "port", monkeypatch)
    ref = write(jtb, tmp_path / "ref", monkeypatch)
    assert os.path.basename(port) == os.path.basename(ref)
    with open(port, "rb") as a, open(ref, "rb") as b:
        assert a.read() == b.read()
    assert len(records(port)) == 1 + 4 + 2


def test_image_record_and_tensorboard_reads_it(tmp_path, monkeypatch):
    img = np.random.RandomState(1).randint(0, 256, (32, 48, 3), np.uint8)
    port = write(ttb, tmp_path / "port", monkeypatch, img)
    ref = write(jtb, tmp_path / "ref", monkeypatch, img)
    got, want = records(port), records(ref)
    assert got[:-1] == want[:-1]

    def image_event(png):
        """The reference's encoding of the image event around ``png``."""
        proto = (jtb._field_varint(1, 32) + jtb._field_varint(2, 48)
                 + jtb._field_varint(3, 3) + jtb._field_bytes(4, png))
        value = jtb._field_bytes(1, b"eval/panel") + jtb._field_bytes(4, proto)
        return jtb._event(9, summary=jtb._field_bytes(1, value),
                          wall_time=WALL)

    png = ttb.encode_png(img)
    assert got[-1] == image_event(png)
    ok, cv2_png = cv2.imencode(".png", np.ascontiguousarray(img[..., ::-1]))
    assert ok and want[-1] == image_event(cv2_png.tobytes())
    decoded = cv2.imdecode(np.frombuffer(png, np.uint8), cv2.IMREAD_COLOR)
    np.testing.assert_array_equal(decoded[..., ::-1], img)

    acc = EventAccumulator(str(tmp_path / "port"))
    acc.Reload()
    assert [e.step for e in acc.Scalars("loss/total")] == [0, 1, 2, 3]
    np.testing.assert_allclose([e.value for e in acc.Scalars("loss/total")],
                               [1, 0.5, 1 / 3, 0.25], rtol=1e-6)
    assert acc.Scalars("eval/miou")[0].value == pytest.approx(0.5)
    assert "eval/note" not in acc.Tags()["scalars"]
    (image,) = acc.Images("eval/panel")
    assert (image.step, image.width, image.height) == (9, 48, 32)
    assert image.encoded_image_string == png


def test_fit_writes_tensorboard(tmp_path):
    """configs/cerberus_evidence_cpu.json cut to 2 epochs of 2 steps with
    train.tensorboard: the loss scalars at log_every, each epoch's row
    and the evaluation panel, read by EventAccumulator."""
    raw = json.loads((REPO_ROOT / "configs" /
                      "cerberus_evidence_cpu.json").read_text())
    raw["data"].update(synthetic_length=4, batch_size=2, hw=[64, 64],
                       num_workers=2)
    raw["model"].update(encoder_channels=[8, 12, 16, 16, 16, 16],
                        est_channels=[16, 16, 12], ctx_channels=[16, 16],
                        fpn_channels=16)
    raw["train"].update(epochs=2, log_every=1, tensorboard=True,
                        ckpt_dir=str(tmp_path / "run"), eval_every_epochs=1)
    tr = Trainer(ExperimentConfig.from_dict(raw), device="cpu")
    history = tr.fit()
    (logfile,) = os.listdir(tmp_path / "run" / "tb")
    acc = EventAccumulator(str(tmp_path / "run" / "tb"))
    acc.Reload()
    tags = acc.Tags()["scalars"]
    assert [e.step for e in acc.Scalars("loss/total")] == [1, 2, 3, 4]
    assert [e.step for e in acc.Scalars("miou")] == [2, 4]
    assert acc.Scalars("miou")[-1].value == pytest.approx(
        history[-1]["miou"], rel=1e-6)
    assert {"loss_total", "epoch_seconds", "flow_epe"} <= set(tags)
    panels = acc.Images("eval/panel")
    assert [p.step for p in panels] == [2, 4]
    assert (panels[0].height, panels[0].width) == (4 * 64, 64)

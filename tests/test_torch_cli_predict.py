"""The port's CLI (cerberusnet_torch/cli.py) on the CPU (``--device cpu``):
``--import-torch`` before ``--infer`` (the files it prints, the npz equal
to the imported ``TorchCerberus`` mirror's forward), ``--infer`` with the
wrong number of images, ``--predict-dir`` and ``--profile`` (a
torch.profiler trace with the train steps' operators). The export and
quantisation flags are tests/test_torch_export.py's."""

import json
import os

import numpy as np
import pytest
import torch

from cerberusnet_torch import cli
from cerberusnet_torch.data.io import write_image_u8
from cerberusnet_torch.data.loader import preprocess
from cerberusnet_torch.testing import one_torch_thread  # noqa: F401
from tools.torch_baseline import TorchCerberus

ENC, EST, CTX = (8, 12, 16, 16, 16, 16), (16, 16, 12), (16, 16)
KEYS = ("left", "right", "temporal")


@pytest.fixture
def config_path(tmp_path):
    path = tmp_path / "tiny.json"
    path.write_text(json.dumps({
        "name": "tiny-cli",
        "model": {"encoder_channels": list(ENC), "est_channels": list(EST),
                  "ctx_channels": list(CTX), "fpn_channels": 16},
        "data": {"hw": [64, 64], "batch_size": 2, "num_workers": 1,
                 "synthetic_length": 3, "shuffle": False},
        "optim": {"schedule": "constant"},
        "train": {"log_every": 1000}}))
    return str(path)


def images(tmp_path):
    rng = np.random.RandomState(1)
    frames = {k: rng.randint(0, 256, (64, 64, 3)).astype(np.uint8)
              for k in KEYS}
    for k, v in frames.items():
        write_image_u8(str(tmp_path / f"{k}.png"), v)
    return frames, ",".join(str(tmp_path / f"{k}.png") for k in KEYS)


def test_import_torch_then_infer(tmp_path, config_path, capsys):
    torch.manual_seed(2)
    mirror = TorchCerberus(enc=ENC, est=EST, ctx=CTX, fpn=16).eval()
    ckpt = str(tmp_path / "mirror.pt")
    torch.save({"model": mirror.state_dict()}, ckpt)
    frames, arg = images(tmp_path)
    out_dir = str(tmp_path / "out")
    assert cli.main(["--config", config_path, "--device", "cpu",
                     "--import-torch", ckpt, "--infer", arg,
                     "--infer-out", out_dir]) == 0
    printed = capsys.readouterr().out
    assert "imported torch weights" in printed
    made = [ln for ln in printed.splitlines() if ln.startswith(out_dir)]
    assert [os.path.relpath(p, out_dir) for p in made] == [
        "sample.npz", "flow/sample.png", "disp_0/sample.png",
        "semantic/sample.png", "sample_panel.png"]
    assert all(os.path.getsize(p) > 0 for p in made)
    prep = preprocess({k: v[None] for k, v in frames.items()}, (64, 64),
                      torch.float32, "cpu")
    with torch.no_grad():
        want = mirror(*[prep[k].permute(0, 3, 1, 2) for k in KEYS])
    got = np.load(made[0])
    for k in ("seg_logits", "flow", "disp"):
        w = want[k][0].permute(1, 2, 0).numpy()
        err = np.abs(got[k] - w).max() / max(np.abs(w).max(), 1)
        assert err <= 1e-4, (k, err)


def test_infer_needs_an_image_per_input(tmp_path, config_path, capsys):
    with pytest.raises(SystemExit) as e:
        cli.main(["--config", config_path, "--device", "cpu",
                  "--infer", "a.png,b.png"])
    assert e.value.code == 2
    assert "--infer needs 3 images (left,right,temporal), got 2" in (
        capsys.readouterr().err)


def test_predict_dir(tmp_path, config_path, capsys):
    out_dir = str(tmp_path / "preds")
    assert cli.main(["--config", config_path, "--device", "cpu",
                     "--predict-dir", out_dir]) == 0
    assert f"wrote 9 prediction files to {out_dir}" in capsys.readouterr().out
    assert sorted(os.listdir(os.path.join(out_dir, "flow"))) == [
        "000000_10.png", "000001_10.png", "000002_10.png"]


def test_profile_writes_a_trace(tmp_path, config_path, capsys):
    log_dir = str(tmp_path / "trace")
    assert cli.main(["--config", config_path, "--device", "cpu",
                     "--profile", log_dir]) == 0
    path = os.path.join(log_dir, "trace.json")
    assert f"trace written to {path}" in capsys.readouterr().out
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any("conv" in n for n in names), sorted(names)[:20]

"""The port's CLI export flags on the CPU (``--device cpu``) at tiny widths:
``--export-dir``, with ``--quant int8`` and with ``--export-stacked``, each
one call of ``cli.main`` that writes ``model.pt2`` and ``manifest.json``;
the float artifact agrees with the trainer's forward."""

import json
import os

import numpy as np
import pytest
import torch

from cerberusnet_torch import cli
from cerberusnet_torch.export import load_exported
from cerberusnet_torch.quant import quantized_apply
from cerberusnet_torch.testing import one_torch_thread  # noqa: F401
from cerberusnet_torch.train.config import ExperimentConfig
from cerberusnet_torch.train.trainer import Trainer

HW = (64, 64)
CONFIG = {
    "name": "tiny-cli-export",
    "model": {"encoder_channels": [8, 12, 16, 16, 16, 16],
              "est_channels": [16, 16, 12], "ctx_channels": [16, 16],
              "fpn_channels": 16},
    "data": {"hw": list(HW), "batch_size": 2, "num_workers": 1,
             "synthetic_length": 2, "shuffle": False},
    "optim": {"schedule": "constant"},
    "train": {"log_every": 1000}}
# flags: the artifact's inputs
CASES = {"float": ([], [[1, *HW, 3]] * 3),
         "int8": (["--quant", "int8"], [[1, *HW, 3]] * 3),
         "stacked": (["--export-stacked"], [[3, *HW, 3]])}


@pytest.mark.parametrize("case", CASES)
def test_cli_exports(case, tmp_path, capsys):
    flags, inputs = CASES[case]
    cfg = tmp_path / "tiny.json"
    cfg.write_text(json.dumps(CONFIG))
    out = str(tmp_path / "art")
    assert cli.main(["--config", str(cfg), "--device", "cpu",
                     "--export-dir", out, *flags]) == 0
    assert f"exported AOT artifact to {out}" in capsys.readouterr().out
    assert os.path.getsize(os.path.join(out, "model.pt2"))
    with open(os.path.join(out, "manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["platforms"] == ["cpu"]
    assert [i["shape"] for i in manifest["inputs"]] == inputs
    assert [o["shape"][-1] for o in manifest["outputs"]] == [19, 2, 1]
    if case == "stacked":
        return  # held to the separate frames in tests/test_torch_export.py
    # the program against the trainer the CLI built, seeded the same way:
    # its forward, or its int8 model under quantized_apply
    rng = np.random.RandomState(0)
    frames = [torch.from_numpy(rng.rand(*s).astype(np.float32))
              for s in inputs]
    tr = Trainer(ExperimentConfig.from_dict(CONFIG), device="cpu")
    with torch.no_grad():
        got = load_exported(out).module()(*frames)
        if case == "int8":
            want = quantized_apply(tr.deploy_model("int8"), *frames)
        else:
            want = tr.model.eval()(*frames)
    for g, k in zip(got, ("seg_logits", "flow", "disp")):
        np.testing.assert_allclose(g.numpy(), want[k].numpy(), rtol=1e-5,
                                   atol=1e-6)

"""``Trainer.import_torch_weights`` of the port (a PyTorch ``TorchCerberus``
checkpoint into the masters, cerberusnet_torch/weights.py's
``load_torch_cerberus``) against the JAX Trainer's, on the CPU.

* A seeded ``TorchCerberus`` (tools/torch_baseline.py, built here at tiny
  widths) saved bare, under "state_dict" and under "model": both
  Trainers import it and their forwards on the same inputs agree within
  1e-4 of max(max|JAX|, 1), and the port's also with the mirror's own
  forward.
* With ``optim.ema_decay`` the EMA holds the imported weights, as the
  reference's does; the optimizer's count and the step stay.
* ``cerberus_dcv``, ``seg_head="aspp"`` and a checkpoint of other widths
  raise.
* ``torch_cerberus_state_dict`` (a port CerberusNet's weights as the
  mirror's state_dict) is the import's inverse: the mirror's own
  state_dict back, key for key, loadable strictly into ``TorchCerberus``.
"""

import jax
import numpy as np
import pytest
import torch

from cerberusnet_torch.data.loader import preprocess
from cerberusnet_torch.models.cerberus import CerberusNet
from cerberusnet_torch.testing import one_torch_thread  # noqa: F401
from cerberusnet_torch.train.config import ExperimentConfig
from cerberusnet_torch.train.trainer import Trainer
from cerberusnet_torch.weights import (
    load_torch_cerberus,
    torch_cerberus_name,
    torch_cerberus_state_dict,
)
from tools.torch_baseline import TorchCerberus

WIDTHS = dict(enc=(8, 12, 16, 16, 16, 16), est=(16, 16, 12), ctx=(16, 16),
              fpn=16, num_classes=19)
KEYS = ("left", "right", "temporal")


def config(**model):
    return {
        "name": "tiny-import",
        "model": {"variant": "cerberus",
                  "encoder_channels": list(WIDTHS["enc"]),
                  "est_channels": list(WIDTHS["est"]),
                  "ctx_channels": list(WIDTHS["ctx"]), "fpn_channels": 16,
                  "corr_impl": "pure", **model},
        "data": {"dataset": "synthetic", "hw": [64, 64], "batch_size": 1,
                 "num_workers": 1, "synthetic_length": 2, "shuffle": False},
        "optim": {"schedule": "constant", "ema_decay": 0.9},
        "train": {"num_data_devices": 1},
    }


def mirror(seed=0, **widths):
    torch.manual_seed(seed)
    return TorchCerberus(**{**WIDTHS, **widths}).eval()


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.RandomState(0)
    frames = {k: rng.randint(0, 256, (1, 64, 64, 3)).astype(np.uint8)
              for k in KEYS}
    return preprocess(frames, (64, 64), torch.float32, "cpu")


@pytest.fixture(scope="module")
def jax_forward():
    from cerberusnet_tpu.train.config import ExperimentConfig as JaxConfig
    from cerberusnet_tpu.train.trainer import Trainer as JaxTrainer

    jt = JaxTrainer(JaxConfig.from_dict(config()))
    return jt, jax.jit(jt.forward)


@pytest.mark.parametrize("wrap", [None, "state_dict", "model"])
def test_imported_forward_equals_jax_trainer(tmp_path, inputs, jax_forward,
                                             wrap):
    t = mirror()
    sd = t.state_dict()
    path = str(tmp_path / "ckpt.pt")
    torch.save(sd if wrap is None else {wrap: sd, "epoch": 3}, path)
    jt, fwd = jax_forward
    jt.import_torch_weights(path)
    want = fwd({"params": jt.state.params},
               {k: inputs[k].numpy() for k in KEYS})
    tr = Trainer(ExperimentConfig.from_dict(config()), device="cpu")
    tr.import_torch_weights(path)
    with torch.no_grad():
        got = tr._forward(inputs)
        mine = t(*[inputs[k].permute(0, 3, 1, 2) for k in KEYS])
    for k in ("seg_logits", "flow", "disp"):
        w = np.asarray(want[k])
        err = np.abs(got[k].numpy() - w).max() / max(np.abs(w).max(), 1)
        assert err <= 1e-4, (k, err)
        m = mine[k].permute(0, 2, 3, 1).numpy()
        err = np.abs(got[k].numpy() - m).max() / max(np.abs(m).max(), 1)
        assert err <= 1e-4, (k, err)


def test_import_sets_masters_and_ema(tmp_path, jax_forward):
    t = mirror(1)
    path = str(tmp_path / "ckpt.pt")
    torch.save(t.state_dict(), path)
    tr = Trainer(ExperimentConfig.from_dict(config()), device="cpu")
    tr.step, tr.optimizer.count = 7, 7
    tr.import_torch_weights(path)
    sd = t.state_dict()
    for key, value in sd.items():
        name = torch_cerberus_name(key, tr.masters)
        assert torch.equal(tr.masters[name], value), key
        assert torch.equal(tr.ema[name], value), key
    assert len(sd) == len(tr.masters)
    for name, p in tr.model.named_parameters():
        assert torch.equal(p.detach(), tr.masters[name]), name
    assert tr.step == 7 and tr.optimizer.count == 7
    jt, _ = jax_forward
    jt.import_torch_weights(path)
    for a, b in zip(jax.tree.leaves(jt.state.ema_params),
                    jax.tree.leaves(jt.state.params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("model,match", [
    ({"variant": "cerberus_dcv"}, "joint CerberusNet mirror"),
    ({"seg_head": "aspp"}, "FPN seg head")])
def test_other_models_raise(tmp_path, model, match):
    path = str(tmp_path / "ckpt.pt")
    torch.save(mirror().state_dict(), path)
    tr = Trainer(ExperimentConfig.from_dict(config(**model)), device="cpu")
    with pytest.raises(ValueError, match=match):
        tr.import_torch_weights(path)


def test_other_widths_raise(tmp_path):
    path = str(tmp_path / "ckpt.pt")
    torch.save(mirror(fpn=24).state_dict(), path)
    tr = Trainer(ExperimentConfig.from_dict(config()), device="cpu")
    with pytest.raises(ValueError, match="does not fit"):
        tr.import_torch_weights(path)


def test_state_dict_round_trip():
    t = mirror(3)
    model = CerberusNet(encoder_channels=WIDTHS["enc"],
                        est_channels=WIDTHS["est"],
                        ctx_channels=WIDTHS["ctx"], fpn_channels=16)
    sd = torch_cerberus_state_dict(load_torch_cerberus(model, t.state_dict()))
    want = t.state_dict()
    assert sorted(sd) == sorted(want)
    for k, v in want.items():
        assert torch.equal(sd[k], v), k
    mirror(4).load_state_dict(sd, strict=True)

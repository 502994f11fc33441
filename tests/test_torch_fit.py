"""The port's training loop (cerberusnet_torch.train: metrics, Trainer.fit,
evaluate, EMA, gradient accumulation, bf16 gradients, remat, checkpoints,
NaN recovery; data.loader's DataLoader; the PNG writer; the CLI) against
the JAX package on the CPU.

Tolerances: a metric function on the same tensors differs from JAX's only
by summation order (counts exact, sums 1e-6 relative). A tiny float32
``fit`` (plain correlations against JAX's ``corr_impl="pure"``, 2 epochs of
2 steps, EMA) holds losses, EPE and MAE to 1e-4 relative, mIoU, Fl-all and
D1-all to 2e-3 absolute (an argmax or a threshold flips on a pixel or two),
and the final masters and EMA to 1e-4 relative L2, as
``test_parameters_after_one_adamw_step`` holds one step. Single steps:
accumulation against the JAX trainer's optax.MultiSteps to 1e-5 relative
L2; bf16 gradients within one bf16 ulp (2^-7) of relative L2 of JAX's;
remat and resume bit-equal on the CPU. The JAX programs here (one CerberusNet
fit, two DCVStereoNet steps) compile once each per module.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cerberusnet_tpu.data import io as jax_io
from cerberusnet_tpu.data.loader import DataLoader as JaxLoader
from cerberusnet_tpu.data.loader import collate as jax_collate
from cerberusnet_tpu.data.loader import pad_batch as jax_pad_batch
from cerberusnet_tpu.data.synthetic import (
    SyntheticPerceptionDataset as JaxSynthetic,
)
from cerberusnet_tpu.train import metrics as jm
from cerberusnet_tpu.train.config import ExperimentConfig as JaxConfig
from cerberusnet_tpu.train.trainer import Trainer as JaxTrainer
from cerberusnet_torch import cli, heldout_table
from cerberusnet_torch.data.loader import DataLoader, batches, pad_batch
from cerberusnet_torch.entry import REPO_ROOT
from cerberusnet_torch.testing import one_torch_thread  # noqa: F401
from cerberusnet_torch.train import metrics as tm
from cerberusnet_torch.train.config import ExperimentConfig
from cerberusnet_torch.train.trainer import UNCERTAINTY, Trainer
from cerberusnet_torch.utils import visualization as vis
from tests.jax_pairs import numpy_tree, port_masters
from tests.test_torch_train import rel, tiny_config_dict


def t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a)).to(dtype)


def config_dict(variant="cerberus", **sections):
    """The tiny experiment (plain correlations, float32, 64x64, batch 2),
    each keyword a section's overrides."""
    raw = tiny_config_dict("pure")
    raw["model"]["variant"] = variant
    for section, values in sections.items():
        raw[section] = {**raw[section], **values}
    return raw


def assert_trees_close(got: dict, want: dict, tol=1e-4):
    assert sorted(got) == sorted(want)
    for name, v in got.items():
        assert rel(v.numpy(), want[name].numpy()) <= tol, name


# --------------------------------------------------------------- metrics


def metric_inputs(seed=0, b=3, h=8, w=12, c=5, sparse=True):
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, c, (b, h, w))
    labels[rng.rand(b, h, w) < 0.2] = 255
    valid = ((rng.rand(b, h, w) < 0.4) if sparse
             else np.ones((b, h, w))).astype(np.float32)
    outputs = {
        "seg_logits": rng.randn(b, h, w, c).astype(np.float32),
        "flow": rng.randn(b, h, w, 2).astype(np.float32) * 6,
        "disp": rng.rand(b, h, w, 1).astype(np.float32) * 30,
    }
    batch = {
        "seg_labels": labels.astype(np.int64),
        "flow_gt": rng.randn(b, h, w, 2).astype(np.float32) * 6,
        "flow_valid": valid,
        "disp_gt": rng.rand(b, h, w).astype(np.float32) * 30 * valid,
        "disp_valid": valid,
    }
    return outputs, batch


def to_torch(tree):
    return {k: t(v, torch.int64 if v.dtype.kind == "i" else torch.float32)
            for k, v in tree.items()}


def to_jax(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def test_confusion_matrix_and_miou():
    out, batch = metric_inputs()
    pred = out["seg_logits"].argmax(-1)
    want = jm.confusion_matrix(jnp.asarray(pred), jnp.asarray(batch["seg_labels"]), 5)
    got = tm.confusion_matrix(t(pred, torch.int64),
                              t(batch["seg_labels"], torch.int64), 5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    iou, present = tm.iou_per_class(got)
    wiou, wpresent = jm.iou_per_class(want)
    np.testing.assert_allclose(iou.numpy(), np.asarray(wiou), rtol=1e-6)
    np.testing.assert_array_equal(present.numpy(), np.asarray(wpresent))
    assert float(tm.miou_from_confusion(got)) == pytest.approx(
        float(jm.miou_from_confusion(want)), rel=1e-6)


@pytest.mark.parametrize("sparse", [False, True])
def test_flow_error_sums(sparse):
    out, batch = metric_inputs(1, sparse=sparse)
    valid = batch["flow_valid"] if sparse else None
    want = jm.flow_error_sums(jnp.asarray(out["flow"]),
                              jnp.asarray(batch["flow_gt"]),
                              None if valid is None else jnp.asarray(valid))
    got = tm.flow_error_sums(t(out["flow"]), t(batch["flow_gt"]),
                             None if valid is None else t(valid))
    np.testing.assert_allclose([float(v) for v in got],
                               [float(v) for v in want], rtol=1e-6)


@pytest.mark.parametrize("trailing,given", [(True, True), (False, False)])
def test_disparity_error_sums(trailing, given):
    out, batch = metric_inputs(2)
    pred = out["disp"] if trailing else out["disp"][..., 0]
    valid = batch["disp_valid"] if given else None
    want = jm.disparity_error_sums(jnp.asarray(pred),
                                   jnp.asarray(batch["disp_gt"]),
                                   None if valid is None else jnp.asarray(valid))
    got = tm.disparity_error_sums(t(pred), t(batch["disp_gt"]),
                                  None if valid is None else t(valid))
    np.testing.assert_allclose([float(v) for v in got],
                               [float(v) for v in want], rtol=1e-6)


@pytest.mark.parametrize("trailing", [True, False])
def test_metric_state_update_and_compute(trailing):
    """Two batches, the second padded (sample mask 1, 1, 0) with sparse
    flow and disparity validity; merged with a third state; per class."""
    outs, bats = [], []
    for seed in (3, 4):
        out, batch = metric_inputs(seed)
        if not trailing:
            out["disp"] = out["disp"][..., 0]
        outs.append(out)
        bats.append(batch)
    bats[1]["_sample_mask"] = np.array([1, 1, 0], np.float32)
    jstate, tstate = jm.MetricState.zeros(5), tm.MetricState.zeros(5)
    for out, batch in zip(outs, bats):
        jstate = jstate.update(to_jax(out), to_jax(batch))
        tstate = tstate.update(to_torch(out), to_torch(batch))
    jstate = jstate.merge(jstate)
    tstate = tstate.merge(tstate)
    np.testing.assert_array_equal(tstate.confusion.numpy(),
                                  np.asarray(jstate.confusion))
    want = jstate.compute(per_class=True)
    got = tstate.compute(per_class=True)
    assert list(got) == list(want)
    for k, v in want.items():
        assert got[k] == pytest.approx(v, rel=1e-6, nan_ok=True), k


# ------------------------------------------------------------------ data


@pytest.mark.parametrize("shuffle,drop_last", [(True, True), (False, False)])
def test_loader_order_equals_jax(shuffle, drop_last):
    kw = dict(length=7, hw=(8, 8))
    ours = DataLoader(JaxSynthetic(**kw), 3, shuffle=shuffle,
                      drop_last=drop_last, seed=5)
    ref = JaxLoader(JaxSynthetic(**kw), 3, shuffle=shuffle, num_workers=1,
                    drop_last=drop_last, seed=5)
    assert len(ours) == len(ref) == (2 if drop_last else 3)
    for _ in range(2):  # two epochs: each shuffles with its own seed
        got, want = list(ours), list(ref)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g["left"], w["left"])


def test_pad_batch_equals_jax():
    ds = JaxSynthetic(length=2, hw=(8, 8))
    batch = jax_collate([ds[0], ds[1]])
    got, mask = pad_batch(batch, 4)
    want, wmask = jax_pad_batch(batch, 4)
    np.testing.assert_array_equal(mask, wmask)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    with pytest.raises(ValueError):
        pad_batch(batch, 1)


# ------------------------------------------------------ one fit against JAX


def fit_config():
    return config_dict(
        data={"synthetic_length": 5, "shuffle": True, "eval_split": "val"},
        optim={"ema_decay": 0.9},
        train={"epochs": 2, "eval_every_epochs": 1})


@pytest.fixture(scope="module")
def jax_fit():
    """The JAX package's fit of the tiny experiment: 2 epochs of 2 shuffled
    steps, the held-out split (5 samples: the last eval batch padded)
    evaluated with the EMA after each; its initial and final parameters."""
    jt = JaxTrainer(JaxConfig.from_dict(fit_config()))
    init = numpy_tree(jt.state.params)
    history = jt.fit()
    return init, history, numpy_tree(jt.state.params), numpy_tree(
        jt.state.ema_params)


@pytest.fixture(scope="module")
def port_fit(jax_fit):
    init, _, _, _ = jax_fit
    tr = Trainer(ExperimentConfig.from_dict(fit_config()), device="cpu")
    tr.load_masters(port_masters(tr.config, init))
    return tr, tr.fit()


LOSSES = ("loss_seg", "loss_flow", "loss_disp", "loss_total")


class TestFitAgainstJax:
    def test_history(self, jax_fit, port_fit):
        _, want, _, _ = jax_fit
        _, got = port_fit
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            assert sorted(g) == sorted(w)
            assert (g["epoch"], g["step"]) == (w["epoch"], w["step"])
            for k in LOSSES + ("flow_epe", "disp_mae"):
                assert g[k] == pytest.approx(w[k], rel=1e-4), k
            for k in ("miou", "flow_fl_all", "disp_d1_all"):
                assert abs(g[k] - w[k]) <= 2e-3, k

    def test_masters_and_ema(self, jax_fit, port_fit):
        _, _, params, ema = jax_fit
        tr, _ = port_fit
        assert tr.step == 4
        assert_trees_close(tr.masters, port_masters(tr.config, params))
        assert_trees_close(tr.ema, port_masters(tr.config, ema))
        assert not all(torch.equal(tr.ema[n], m)
                       for n, m in tr.masters.items())


# ----------------------------------------------- single steps against JAX


def stereo_batches(n=2):
    ds = JaxSynthetic(length=2 * n, hw=(64, 64))
    return [jax_collate([ds[2 * i], ds[2 * i + 1]]) for i in range(n)]


def stereo_pair(**sections):
    """A JAX trainer of the tiny DCVStereoNet (float32) and the port's with
    the same config and initial weights."""
    raw = config_dict("dcv_stereo", **sections)
    jt = JaxTrainer(JaxConfig.from_dict(raw))
    tr = Trainer(ExperimentConfig.from_dict(raw), device="cpu")
    tr.load_masters(port_masters(tr.config, numpy_tree(jt.state.params)))
    return jt, tr


def test_accumulation_against_multisteps():
    """accum_steps=2, SGD with momentum, a one-cycle schedule (its rate
    differs at each update count) and a clip below the mean gradient's
    norm, EMA 0.9: four calls, updates at calls 2 and 4 only; masters and
    EMA held to the JAX trainer's after each call."""
    clip = 0.01
    jt, tr = stereo_pair(
        optim={"optimizer": "sgd", "lr": 0.05, "schedule": "onecycle",
               "total_steps": 10, "grad_clip": clip, "accum_steps": 2,
               "ema_decay": 0.9})
    bs = stereo_batches()
    g0, g1 = (tr.loss_and_grads(b)[1] for b in bs)
    mean_norm = torch.linalg.vector_norm(torch.cat(
        [(g0[n] + g1[n]).flatten() / 2 for n in tr.names]))
    assert mean_norm > 2 * clip  # the clip acts on the mean
    prev = {n: m.clone() for n, m in tr.masters.items()}
    for call, b in enumerate(bs * 2, 1):
        jt.train_step(b)
        tr.train_step(b)
        moved = [n for n, m in tr.masters.items() if not torch.equal(m, prev[n])]
        # a micro-step changes no master; an update moves them
        assert bool(moved) == (call % 2 == 0), call
        prev = {n: m.clone() for n, m in tr.masters.items()}
        assert_trees_close(
            tr.masters, port_masters(tr.config, numpy_tree(jt.state.params)),
            1e-5)
        assert_trees_close(
            tr.ema, port_masters(tr.config, numpy_tree(jt.state.ema_params)),
            1e-5)
        assert tr.step == int(jt.state.step) == call
    assert tr.optimizer.count == 2


def test_bf16_gradients_against_jax():
    """grads_dtype="bfloat16" on a float32 model with the log-variances:
    JAX's gradient from one SGD step at lr 1024 (p1 = p0 - 1024 g, exact
    in float32 up to the rounding of p1), the port's from loss_and_grads,
    each parameter's within one bf16 ulp (2^-7) of relative L2. The
    decoder's agree element by element; the encoder's do not: there JAX's
    own bf16-mode gradients sit 0.1-0.4% (relative L2) from its float32
    gradients at the bf16-rounded parameters, rounded, while the port's are
    exactly those. Every port gradient is a bf16 value, and some are not
    the float32 ones."""
    lr = 1024.0
    jt, tr = stereo_pair(
        optim={"optimizer": "sgd", "lr": lr, "schedule": "constant",
               "grad_clip": 0.0, "grads_dtype": "bfloat16"},
        loss={"uncertainty_weighting": True})
    (batch,) = stereo_batches(1)
    p0 = port_masters(tr.config, numpy_tree(jt.state.params))
    jt.train_step(batch)
    p1 = port_masters(tr.config, numpy_tree(jt.state.params))
    _, grads = tr.loss_and_grads(batch)
    f32 = Trainer(ExperimentConfig.from_dict(config_dict(
        "dcv_stereo", loss={"uncertainty_weighting": True})), device="cpu")
    f32.load_masters(p0)
    _, grads32 = f32.loss_and_grads(batch)
    for n, g in grads.items():
        want = ((p0[n].double() - p1[n].double()) / lr).numpy()
        np.testing.assert_array_equal(g.numpy(), g.bfloat16().float().numpy())
        assert rel(g.numpy(), want) <= 2**-7, n
    assert any(not torch.equal(grads[n], grads32[n]) for n in grads)
    # the leaves hold their masters again
    for p, n in zip(tr._params, tr.names):
        assert torch.equal(p.detach(), tr.masters[n]), n


def test_bf16_gradients_of_a_bf16_model():
    """In a bf16 model the float32 leaves are the classifier and the
    log-variances: their gradients are bf16 values too, and they hold
    their masters after the step."""
    raw = config_dict(model={"dtype": "bfloat16"},
                      optim={"grads_dtype": "bfloat16"},
                      loss={"uncertainty_weighting": True})
    tr = Trainer(ExperimentConfig.from_dict(raw), device="cpu")
    (batch,) = batches(tr.dataset, 2, 1)
    _, grads = tr.loss_and_grads(batch)
    f32 = [n for n, p in zip(tr.names, tr._params) if p.dtype == torch.float32]
    assert sorted(f32) == sorted(
        ["segmentation.classifier.weight", "segmentation.classifier.bias"]
        + [f"{UNCERTAINTY}.{k}" for k in ("seg", "flow", "disp")])
    for n in f32:
        assert torch.equal(grads[n], grads[n].bfloat16().float()), n
    for p, n in zip(tr._params, tr.names):
        assert torch.equal(p.detach().float(),
                           tr.masters[n].to(p.dtype).float()), n


def test_grads_dtype_must_be_known():
    cfg = ExperimentConfig.from_dict(config_dict(optim={"grads_dtype": "f16"}))
    with pytest.raises(ValueError, match="grads_dtype"):
        Trainer(cfg, device="cpu")


def test_remat_is_bit_equal():
    (batch,) = stereo_batches(1)
    out = []
    for remat in (False, True):
        tr = Trainer(ExperimentConfig.from_dict(config_dict(
            "dcv_stereo", train={"remat": remat})), device="cpu")
        out.append(tr.loss_and_grads(batch))
    (c0, g0), (c1, g1) = out
    for k in c0:
        assert torch.equal(c0[k], c1[k]), k
    for n in g0:
        assert torch.equal(g0[n], g1[n]), n


# ------------------------------------------------------------- port only


def tiny_trainer(tmp_path=None, **sections):
    if tmp_path is not None:
        sections["train"] = {"ckpt_dir": str(tmp_path / "ck"),
                             **sections.get("train", {})}
    return Trainer(ExperimentConfig.from_dict(config_dict(**sections)),
                   device="cpu")


def test_resume_reproduces_the_next_step(tmp_path):
    """Three calls with accum_steps=2 (a half-filled accumulator), a
    checkpoint, a new trainer restoring it: the same state, bit for bit,
    and the same next step."""
    kw = dict(optim={"accum_steps": 2, "ema_decay": 0.9},
              train={"keep_checkpoints": 2})
    a = tiny_trainer(tmp_path, **kw)
    bs = batches(a.dataset, 2, 2)
    for b in (bs[0], bs[1], bs[0]):
        a.train_step(b)
    a.save_checkpoint()
    b = tiny_trainer(tmp_path, **kw)
    assert b.step == 3 and b._mini_step == 1
    for n in a.names:
        assert torch.equal(a.masters[n], b.masters[n]), n
        assert torch.equal(a.ema[n], b.ema[n]), n
    for x, y in zip(a._accum, b._accum):
        assert torch.equal(x, y)
    sa, sb = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert sa["count"] == sb["count"] == 1
    for i, st in sa["opt"]["state"].items():
        for k, v in st.items():
            assert torch.equal(v, sb["opt"]["state"][i][k]), (i, k)
    ca, cb = a.train_step(bs[1]), b.train_step(bs[1])
    for k in ca:
        assert torch.equal(ca[k], cb[k]), k
    for n in a.names:
        assert torch.equal(a.masters[n], b.masters[n]), n
    # keep_checkpoints: the newest two stay, no temporary file
    for _ in range(2):
        a.train_step(bs[0])
        a.save_checkpoint()
    assert sorted(os.listdir(tmp_path / "ck")) == [
        "ckpt_00000005.pt", "ckpt_00000006.pt"]


def test_evaluate_leaves_the_masters(tmp_path):
    """A bf16 model with EMA: evaluate() runs the EMA (the metrics of a
    trainer whose masters are the EMA), changes no master, and the next
    step equals the step of a twin that did not evaluate."""
    kw = dict(model={"dtype": "bfloat16"}, optim={"ema_decay": 0.5},
              data={"eval_split": "val"})
    a, twin = tiny_trainer(**kw), tiny_trainer(**kw)
    bs = batches(a.dataset, 2, 2)
    for tr in (a, twin):
        tr.train_step(bs[0])
    masters = {n: m.clone() for n, m in a.masters.items()}
    params = [p.detach().clone() for p in a._params]
    got = a.evaluate()
    for n, m in a.masters.items():
        assert torch.equal(m, masters[n]), n
    for p, q in zip(a._params, params):
        assert torch.equal(p.detach(), q)
    ema_as_masters = tiny_trainer(model={"dtype": "bfloat16"},
                                  data={"eval_split": "val"})
    ema_as_masters.load_masters(a.ema)
    assert ema_as_masters.evaluate() == got
    assert a.evaluate() == got
    ca, ct = a.train_step(bs[1]), twin.train_step(bs[1])
    for k in ca:
        assert torch.equal(ca[k], ct[k]), k
    for n in a.names:
        assert torch.equal(a.masters[n], twin.masters[n]), n


def nan_injector(trainer, fail_steps):
    """Wraps trainer.train_step to report a NaN loss at the given call
    indices (tests/test_recovery.py's injector)."""
    real = trainer.train_step
    counter = {"n": 0}

    def wrapped(batch):
        comps = real(batch)
        counter["n"] += 1
        if counter["n"] in fail_steps:
            comps = dict(comps)
            comps["total"] = np.float32("nan")
        return comps

    trainer.train_step = wrapped
    return counter


class TestNanRecovery:
    """tests/test_recovery.py's cases on the port (the tiny CerberusNet:
    the port has no segmentation-only variant yet)."""

    def test_recovers_and_continues(self, tmp_path):
        tr = tiny_trainer(tmp_path, train={"epochs": 2,
                                           "recover_on_nan": True})
        tr.save_checkpoint()
        nan_injector(tr, {2})
        tr.fit()
        assert tr.step > 0
        assert np.isfinite(list(tr.history[-1].values())[-1])

    def test_aborts_after_max_recoveries(self, tmp_path):
        tr = tiny_trainer(tmp_path, train={"epochs": 3,
                                           "recover_on_nan": True,
                                           "max_nan_recoveries": 1})
        tr.save_checkpoint()
        nan_injector(tr, {1, 2, 3, 4, 5, 6})
        with pytest.raises(RuntimeError, match="non-finite"):
            tr.fit()

    def test_off_by_default(self):
        assert ExperimentConfig.from_dict(
            config_dict()).train.recover_on_nan is False

    def test_initial_rollback_checkpoint_saved(self, tmp_path):
        tr = tiny_trainer(tmp_path, train={"recover_on_nan": True})
        assert tr._checkpoints() == {}
        nan_injector(tr, {1})
        tr.fit()
        assert tr.step > 0
        assert 0 in tr._checkpoints()

    def test_no_ckpt_dir_recovery_warns_and_reinits(self, capsys):
        tr = tiny_trainer(train={"recover_on_nan": True})
        nan_injector(tr, {2})
        tr.fit()
        assert "WARNING: no checkpoint to restore" in capsys.readouterr().out
        assert tr.step == 0  # step 2 failed: re-initialised at step 0

    def test_recovery_counter_resets_after_healthy_stretch(self, tmp_path):
        tr = tiny_trainer(tmp_path, train={"epochs": 4,
                                           "recover_on_nan": True,
                                           "max_nan_recoveries": 1,
                                           "nan_recovery_reset_steps": 2})
        tr.save_checkpoint()
        nan_injector(tr, {1, 5})
        tr.fit()
        assert tr.step > 0


def test_png_round_trip(tmp_path):
    img = np.random.RandomState(0).randint(0, 256, (5, 7, 3)).astype(np.uint8)
    path = vis.write_png_u8(str(tmp_path / "x.png"), img)
    np.testing.assert_array_equal(vis.read_png_u8(path), img)
    # the JAX package's reader (cv2) decodes the same pixels
    np.testing.assert_array_equal(jax_io.read_image_u8(path), img)
    with pytest.raises(ValueError):
        vis.write_png_u8(str(tmp_path / "y.png"), img[..., 0])


def test_evidence_cpu_fit(tmp_path):
    """configs/cerberus_evidence_cpu.json cut to 2 epochs of 2 steps,
    evaluating and checkpointing each epoch: the history, the CSV log, the
    panels and the newest checkpoint."""
    raw = json.loads((REPO_ROOT / "configs" /
                      "cerberus_evidence_cpu.json").read_text())
    raw["data"]["synthetic_length"] = 8
    raw["train"].update(epochs=2, eval_every_epochs=1, ckpt_every_epochs=1,
                        ckpt_dir=str(tmp_path))
    tr = Trainer(ExperimentConfig.from_dict(raw), device="cpu")
    history = tr.fit()
    assert [r["step"] for r in history] == [2, 4]
    assert all(np.isfinite(r[k]) for r in history
               for k in tm.METRICS + LOSSES)
    lines = (tmp_path / "train_log.csv").read_text().splitlines()
    assert len(lines) == 3 and lines[0].split(",") == sorted(history[0])
    for e in (0, 1):
        panel = vis.read_png_u8(str(tmp_path / f"predictions_epoch{e}.png"))
        assert panel.shape == (4 * 64, 64, 3)
    assert sorted(tr._checkpoints()) == [2, 4]


def test_heldout_table(tmp_path):
    """The table of a train_log.csv: the evaluated epochs' metrics, the
    median ms a step over the epochs and the training minutes."""
    path = tmp_path / "train_log.csv"
    path.write_text(
        "disp_d1_all,disp_mae,epoch,epoch_seconds,flow_epe,flow_fl_all,"
        "miou,step\n"
        ",,0,6.0,,,,2\n"
        "0.5,3.25,1,3.0,1.5,0.125,0.25,4\n"
        "0.25,2.5,2,9.0,1.25,0.0625,0.375,6\n")
    lines = heldout_table.table(str(path)).splitlines()
    assert lines[2] == "| val metric | epoch 1 | epoch 2 |"
    assert "| seg mIoU | 0.25 | 0.375 |" in lines
    assert "| flow Fl-all (%) | 12.5 | 6.25 |" in lines
    assert "| disp MAE (px) | 3.25 | 2.5 |" in lines
    assert lines[-1] == ("ms per step, median over 3 epochs: 3000.0 (min "
                         "1500.0, max 4500.0); training minutes: 0.30")


@pytest.mark.parametrize("flag,message", [
    (["--export-stacked"], "need --export-dir"),
    (["--quant", "int8"], "need --export-dir"),
    (["--export-dir", "d", "--quant", "int4"], "invalid choice"),
])
def test_cli_unported_flags_raise(flag, message, capsys):
    """The export flags are ported (tests/test_torch_export.py); what
    the CLI still refuses is an export option without --export-dir (the
    reference ignores it and trains) and an unknown --quant mode."""
    cfg = str(REPO_ROOT / "configs" / "cerberus_evidence_cpu.json")
    with pytest.raises(SystemExit):
        cli.main(["--config", cfg, *flag])
    assert message in capsys.readouterr().err


def test_cli_print_config_and_eval_only(tmp_path, capsys):
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(config_dict(data={"eval_split": "val"})))
    assert cli.main(["--config", str(path), "--print-config",
                     "--ckpt-dir", "elsewhere"]) == 0
    printed = ExperimentConfig.from_json(capsys.readouterr().out)
    assert printed.train.ckpt_dir == "elsewhere"
    assert printed.data.eval_split == "val"
    assert cli.main(["--config", str(path), "--eval-only",
                     "--device", "cpu"]) == 0
    metrics = json.loads(capsys.readouterr().out)
    assert tuple(metrics) == tm.METRICS

"""The port's training path (cerberusnet_torch.train, .data, train_entry)
against the JAX package.

The same numpy tensors and batches go through the JAX functions and the
port on the CPU. Tolerances: losses in float32 differ only by summation
order (1e-6 relative); schedules and optimizer updates by float rounding
(1e-6); one train step of the tiny model, whose JAX correlations are the
Pallas kernels in interpret mode, to 1e-5 relative in the loss and 1e-4
relative L2 in every gradient and updated parameter.
"""

import dataclasses
import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cerberusnet_tpu.data.loader import collate as jax_collate
from cerberusnet_tpu.data.loader import make_preprocess_fn
from cerberusnet_tpu.data.synthetic import (
    SyntheticPerceptionDataset as JaxSynthetic,
)
from cerberusnet_tpu.train import losses as jl
from cerberusnet_tpu.train.config import ExperimentConfig as JaxConfig
from cerberusnet_tpu.train.config import OptimConfig as JaxOptimConfig
from cerberusnet_tpu.train.trainer import build_model as jax_build_model
from cerberusnet_tpu.train.trainer import build_optimizer as jax_build_optimizer
from cerberusnet_torch.data.loader import batches, preprocess
from cerberusnet_torch.data.synthetic import SyntheticPerceptionDataset
from cerberusnet_torch.entry import REPO_ROOT, train_entry
from cerberusnet_torch.models.cerberus import CerberusNet
from cerberusnet_torch.train import losses as tl
from cerberusnet_torch.train.config import ExperimentConfig, OptimConfig
from cerberusnet_torch.train.trainer import (
    Optimizer,
    Trainer,
    build_schedule,
    check_spatial_mesh,
)
from cerberusnet_torch.testing import one_torch_thread  # noqa: F401
from cerberusnet_torch.weights import load_flax_params



TINY = dict(
    encoder_channels=(8, 12, 16, 16, 16, 16),
    est_channels=(16, 16, 12),
    ctx_channels=(16, 16),
    fpn_channels=16,
)


def tiny_config_dict(corr_impl="pallas"):
    """The tiny experiment of tests/test_train_step.py (copied)."""
    return {
        "name": "tiny-test",
        "model": {"variant": "cerberus", **{k: list(v) if isinstance(v, tuple)
                                            else v for k, v in TINY.items()},
                  "corr_impl": corr_impl},
        "data": {"dataset": "synthetic", "hw": [64, 64], "batch_size": 2,
                 "num_workers": 1, "synthetic_length": 4, "shuffle": False},
        "optim": {"lr": 2e-3, "warmup_steps": 0, "total_steps": 100,
                  "schedule": "constant"},
        "loss": {},
        "train": {"epochs": 1, "ckpt_dir": "", "log_every": 1000,
                  "num_data_devices": 1},
    }


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a)).to(dtype)


# ---------------------------------------------------------------- data


@pytest.mark.parametrize("seed,idx,sparse", [(0, 1, False), (3, 0, True)])
def test_synthetic_dataset_equals_jax(seed, idx, sparse):
    kw = dict(length=4, hw=(24, 40), num_classes=7, sparse=sparse, seed=seed)
    got = SyntheticPerceptionDataset(**kw)[idx]
    want = JaxSynthetic(**kw)[idx]
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_preprocess_equals_jax():
    ds = JaxSynthetic(length=2, hw=(16, 24), sparse=True)
    batch = jax_collate([ds[0], ds[1]])
    want = make_preprocess_fn((16, 24))(batch)
    got = preprocess(batch, (16, 24), torch.float32, "cpu")
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-6, err_msg=k)
    assert got["seg_labels"].dtype == torch.int64
    assert preprocess(batch, (16, 24), torch.bfloat16, "cpu")[
        "left"].dtype == torch.bfloat16
    # another size is resized as the reference resizes it (bilinear images,
    # nearest ground truth with its values scaled)
    want = make_preprocess_fn((32, 48))(batch)
    got = preprocess(batch, (32, 48), torch.float32, "cpu")
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=1e-5, err_msg=k)


def test_batches_stack_in_order():
    ds = SyntheticPerceptionDataset(length=5, hw=(8, 8))
    out = batches(ds, 2)
    assert len(out) == 2
    np.testing.assert_array_equal(out[1]["left"][1], ds[3]["left"])
    with pytest.raises(ValueError):
        batches(ds, 2, 3)


# -------------------------------------------------------------- config


@pytest.mark.parametrize(
    "path", sorted(glob.glob(str(REPO_ROOT / "configs" / "*.json"))),
    ids=os.path.basename)
def test_every_config_parses_as_in_jax(path):
    got = dataclasses.asdict(ExperimentConfig.from_json(path))
    want = dataclasses.asdict(JaxConfig.from_json(path))
    assert got == want


def test_unknown_key_raises():
    with pytest.raises(ValueError, match="unknown config key"):
        ExperimentConfig.from_dict({"optim": {"lr_typo": 1.0}})


@pytest.mark.parametrize("values,message", [
    ({"model": {"variant": "pwc"}}, "unknown model variant 'pwc'"),
    ({"data": {"dataset": "imagenet"}}, "unknown dataset 'imagenet'"),
], ids=["model-variant-pwc-A8", "data-dataset-imagenet"])
def test_unported_values_raise(values, message):
    """The reference's ValueErrors for a variant or a dataset that neither
    package knows."""
    raw = tiny_config_dict()
    for section, entries in values.items():
        raw[section].update(entries)
    cfg = ExperimentConfig.from_dict(raw)
    with pytest.raises(ValueError, match=message):
        Trainer(cfg, device="cpu")


def test_spatial_axis_off_the_grid_is_supported():
    """CerberusDCV under the spatial axis at an H that is no multiple of
    2^6 (A11d) passes the check, and the guard gives the mesh the frame's
    "SAME" extents (tests/test_torch_spatial_offgrid.py trains there)."""
    raw = tiny_config_dict()
    raw["model"]["variant"] = "cerberus_dcv"
    raw["data"]["hw"] = [200, 128]
    raw["train"]["num_spatial_devices"] = 2
    cfg = ExperimentConfig.from_dict(raw)
    cfg.check_supported()
    assert check_spatial_mesh(cfg) == (200, 100, 50, 25, 13, 7, 4)


@pytest.mark.parametrize("ranks", [4, 8])
def test_data_parallel_values_pass_and_need_their_ranks(ranks):
    """train.num_data_devices > 1 (A11) passes the check; a Trainer in a
    process that is not one of that many ranks raises ValueError naming
    both counts (tests/test_torch_parallel.py trains on two)."""
    raw = tiny_config_dict()
    raw["train"]["num_data_devices"] = ranks
    cfg = ExperimentConfig.from_dict(raw)
    cfg.check_supported()
    with pytest.raises(ValueError, match=f"asks for {ranks} data ranks, and "
                                         f"this process is one of 1"):
        Trainer(cfg, device="cpu")


@pytest.mark.parametrize("section,key,value", [
    ("data", "dataset", "sintel"), ("data", "dataset", "flyingchairs"),
    ("data", "dataset", "flyingthings3d"), ("loss", "rmi_weight", 0.5),
    ("loss", "photometric_weight", 0.1), ("loss", "smoothness_weight", 0.1),
])
def test_flow_datasets_and_auxiliary_losses_are_supported(section, key,
                                                          value):
    raw = tiny_config_dict()
    raw[section][key] = value
    ExperimentConfig.from_dict(raw).check_supported()


@pytest.mark.parametrize("key", ["debug_nans", "qat"])
def test_deployment_values_are_supported(key):
    """train.debug_nans (A5) and train.qat (A10) are ported."""
    raw = tiny_config_dict()
    raw["train"][key] = True
    ExperimentConfig.from_dict(raw).check_supported()


EVIDENCE = ("cerberus_evidence", "cerberus_evidence60", "cerberus_evidence_cpu",
            "dcv_evidence", "dcv_evidence60", "wide_evidence",
            "cerberus_evidence_bf16g", "raft_evidence", "raft_evidence60",
            "raft_lv4_evidence")


@pytest.mark.parametrize("name", EVIDENCE)
def test_evidence_config_is_supported(name):
    cfg = ExperimentConfig.from_json(
        str(REPO_ROOT / "configs" / f"{name}.json"))
    cfg.check_supported()
    assert cfg.optim.ema_decay > 0 and cfg.data.eval_split == "val"


@pytest.mark.parametrize("name,level,iters", [("cerberus_raft", 3, 12),
                                               ("raft_lv4_deploy", 4, 6)])
def test_raft_config_is_supported(name, level, iters):
    cfg = ExperimentConfig.from_json(
        str(REPO_ROOT / "configs" / f"{name}.json"))
    cfg.check_supported()
    m = cfg.model
    assert (m.variant, m.raft_level, m.raft_iters) == ("cerberus_raft",
                                                       level, iters)
    assert m.torch_dtype == torch.bfloat16 and cfg.loss.seq_gamma == 0.8


def test_raft_kitti_waits_on_the_data_pipeline():
    """raft_kitti waited on the KITTI dataset (A6); with the data pipeline
    ported it is supported, and with data parallelism (A11) all 23 configs
    pass the check, cerberus_dp_v4_8 (8 devices) among them."""
    cfg = ExperimentConfig.from_json(
        str(REPO_ROOT / "configs" / "raft_kitti.json"))
    assert cfg.model.variant == "raft"
    cfg.check_supported()
    paths = sorted(glob.glob(str(REPO_ROOT / "configs" / "*.json")))
    assert len(paths) == 23
    for path in paths:
        ExperimentConfig.from_json(path).check_supported()
    dp = ExperimentConfig.from_json(
        str(REPO_ROOT / "configs" / "cerberus_dp_v4_8.json"))
    assert dp.train.num_data_devices == 8


@pytest.mark.parametrize("name", ["cerberus_dcv.json"])
def test_dcv_config_is_supported(name):
    cfg = ExperimentConfig.from_json(str(REPO_ROOT / "configs" / name))
    cfg.check_supported()
    assert cfg.model.variant == "cerberus_dcv"
    assert cfg.loss.uncertainty_weighting
    assert cfg.model.port_corr_impl is None
    # the W-in-lanes Pallas layout (K7, K8) runs on the same CUDA kernels
    wl = ExperimentConfig.from_dict(tiny_config_dict("pallas_wl"))
    wl.check_supported()
    assert wl.model.port_corr_impl is None


def test_fused_encoder_levels_are_supported():
    raw = tiny_config_dict()
    raw["model"].update(pallas_levels=3, pallas_grad="pallas")
    cfg = ExperimentConfig.from_dict(raw)
    cfg.check_supported()
    tr = Trainer(cfg, device="cpu")
    assert tr.model.encoder.fused_levels == 3
    assert tr.model.encoder.pallas_grad == "pallas"
    # the DCV variants accept the knobs and ignore them, as in JAX
    raw["model"]["variant"] = "cerberus_dcv"
    dcv = ExperimentConfig.from_dict(raw)
    dcv.check_supported()
    assert Trainer(dcv, device="cpu").model.encoder.fused_levels == 0


def test_synthetic_config_is_supported():
    cfg = ExperimentConfig.from_json(
        str(REPO_ROOT / "configs" / "cerberus_synthetic.json"))
    cfg.check_supported()
    assert cfg.model.torch_dtype == torch.bfloat16
    assert cfg.model.port_corr_impl is None
    assert ExperimentConfig.from_dict(tiny_config_dict("pure")
                                      ).model.port_corr_impl == "plain"


# -------------------------------------------------------------- losses


def loss_inputs(sparse, seed=0):
    """A 3-level pyramid at 32x48 for both tasks, labels with ignored
    pixels, dense or sparse ground truth, as numpy arrays."""
    rng = np.random.RandomState(seed)
    b, h, w = 2, 32, 48
    out = {
        "seg_logits": rng.randn(b, h, w, 5).astype(np.float32) * 2,
        "flow_pyramid": {l: rng.randn(b, h >> l, w >> l, 2).astype(np.float32)
                         for l in (2, 3, 4)},
        "disp_pyramid": {l: rng.rand(b, h >> l, w >> l, 1).astype(np.float32)
                         * 3 for l in (2, 3, 4)},
    }
    labels = rng.randint(0, 5, (b, h, w))
    labels[rng.rand(b, h, w) < 0.2] = 255
    valid = ((rng.rand(b, h, w) < 0.3) if sparse
             else np.ones((b, h, w))).astype(np.float32)
    batch = {
        "seg_labels": labels.astype(np.int32),
        "flow_gt": rng.randn(b, h, w, 2).astype(np.float32) * 8 * valid[..., None],
        "flow_valid": valid,
        "disp_gt": rng.rand(b, h, w).astype(np.float32) * 20 * valid,
        "disp_valid": valid,
    }
    return out, batch


def to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def to_torch(tree):
    return jax.tree.map(
        lambda a: t(a, torch.int64 if a.dtype.kind == "i" else torch.float32),
        tree)


def assert_rel(got, want, tol=1e-6, what=""):
    got, want = float(got.detach() if hasattr(got, "detach") else got), float(want)
    assert abs(got - want) <= tol * max(abs(want), 1e-30), (what, got, want)


@pytest.mark.parametrize("focal", [None, 2.0])
def test_segmentation_loss(focal):
    out, batch = loss_inputs(False)
    want = jl.segmentation_loss(jnp.asarray(out["seg_logits"]),
                                jnp.asarray(batch["seg_labels"]),
                                focal_gamma=focal)
    got = tl.segmentation_loss(t(out["seg_logits"]),
                               t(batch["seg_labels"], torch.int64),
                               focal_gamma=focal)
    assert_rel(got, want)


def test_segmentation_loss_all_ignored_is_zero():
    logits = torch.randn(1, 4, 4, 3)
    labels = torch.full((1, 4, 4), 255)
    assert float(tl.segmentation_loss(logits, labels)) == 0.0


@pytest.mark.parametrize("sparse", [False, True])
def test_gt_pyramid(sparse):
    _, batch = loss_inputs(sparse)
    want = jl.gt_pyramid(jnp.asarray(batch["flow_gt"]),
                         jnp.asarray(batch["flow_valid"]), (2, 3, 4), True)
    got = tl.gt_pyramid(t(batch["flow_gt"]), t(batch["flow_valid"]),
                        (2, 3, 4), True)
    for level in (2, 3, 4):
        for g, w in zip(got[level], want[level]):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                       atol=1e-6)


@pytest.mark.parametrize("sparse,robust_q", [(False, None), (True, None),
                                             (True, 0.4)])
def test_multiscale_flow_loss(sparse, robust_q):
    out, batch = loss_inputs(sparse)
    want = jl.multiscale_flow_loss(
        to_jax(out["flow_pyramid"]), jnp.asarray(batch["flow_gt"]),
        jnp.asarray(batch["flow_valid"]), robust_q=robust_q)
    got = tl.multiscale_flow_loss(
        to_torch(out["flow_pyramid"]), t(batch["flow_gt"]),
        t(batch["flow_valid"]), robust_q=robust_q)
    assert_rel(got, want)


@pytest.mark.parametrize("sparse", [False, True])
def test_disparity_losses(sparse):
    out, batch = loss_inputs(sparse)
    pred = out["disp_pyramid"][2][..., 0]
    gt = batch["disp_gt"][:, ::4, ::4]
    valid = batch["disp_valid"][:, ::4, ::4]
    assert_rel(tl.berhu_loss(t(pred), t(gt), t(valid)),
               jl.berhu_loss(jnp.asarray(pred), jnp.asarray(gt),
                             jnp.asarray(valid)), what="berhu")
    want = jl.multiscale_disparity_loss(
        to_jax(out["disp_pyramid"]), jnp.asarray(batch["disp_gt"]),
        jnp.asarray(batch["disp_valid"]))
    got = tl.multiscale_disparity_loss(
        to_torch(out["disp_pyramid"]), t(batch["disp_gt"]),
        t(batch["disp_valid"]))
    assert_rel(got, want, what="multiscale")


@pytest.mark.parametrize("sparse,focal,robust_q", [(False, None, None),
                                                   (True, 2.0, 0.4)])
def test_joint_loss_values_and_gradients(sparse, focal, robust_q):
    out, batch = loss_inputs(sparse)
    weights = {"seg": 1.0, "flow": 0.5, "disp": 2.0}

    def jax_total(o):
        return jl.joint_loss(o, to_jax(batch), weights=weights,
                             focal_gamma=focal, robust_q=robust_q)

    (jtotal, jcomps), jgrads = jax.value_and_grad(jax_total, has_aux=True)(
        to_jax(out))
    tout = jax.tree.map(lambda a: t(a).requires_grad_(), out)
    ttotal, tcomps = tl.joint_loss(tout, to_torch(batch), weights=weights,
                                   focal_gamma=focal, robust_q=robust_q)
    assert sorted(tcomps) == sorted(jcomps) == ["disp", "flow", "seg",
                                                "total"]
    for k in jcomps:
        assert_rel(tcomps[k], jcomps[k], what=k)
    ttotal.backward()
    leaves = jax.tree.leaves(tout)
    assert len(leaves) == 7
    for leaf, want in zip(leaves, jax.tree.leaves(jgrads)):
        assert rel(leaf.grad.numpy(), want) <= 1e-5


# ----------------------------------------------------------- optimizer


def optax_schedule(c):
    """The optax schedule that cerberusnet_tpu's build_optimizer builds."""
    if c.schedule == "cosine":
        return optax.warmup_cosine_decay_schedule(0.0, c.lr, c.warmup_steps,
                                                  c.total_steps)
    if c.schedule == "onecycle":
        return optax.linear_onecycle_schedule(c.total_steps, c.lr)
    if c.schedule == "poly":
        return optax.polynomial_schedule(
            c.lr, c.lr * 1e-3, c.poly_power, c.total_steps - c.warmup_steps,
            transition_begin=c.warmup_steps)
    return lambda count: c.lr


@pytest.mark.parametrize("schedule,warmup", [("cosine", 3), ("cosine", 0),
                                             ("poly", 4), ("onecycle", 0),
                                             ("constant", 5)])
def test_schedule_matches_optax(schedule, warmup):
    cfg = OptimConfig(lr=3e-4, schedule=schedule, warmup_steps=warmup,
                      total_steps=20)
    ours, want = build_schedule(cfg), optax_schedule(cfg)
    for count in range(26):  # past the end of the schedule
        assert ours(count) == pytest.approx(
            float(want(jnp.int32(count))), rel=1e-6, abs=1e-10), count
    if schedule == "cosine" and warmup:
        assert ours(0) == 0.0


def param_tree(rng):
    return {"a": rng.randn(3, 4).astype(np.float32),
            "b": {"k": rng.randn(2, 3).astype(np.float32),
                  "bias": rng.randn(3).astype(np.float32) * 0.1}}


@pytest.mark.parametrize("optimizer,clip", [("adamw", 1.0), ("adamw", 50.0),
                                            ("adam", 1.0), ("sgd", 0.5)])
def test_ten_updates_match_optax(optimizer, clip):
    rng = np.random.RandomState(4)
    params = param_tree(rng)
    grads = [param_tree(rng) for _ in range(10)]
    kw = dict(optimizer=optimizer, lr=1e-2, weight_decay=0.1,
              schedule="cosine", warmup_steps=2, total_steps=12,
              grad_clip=clip)
    # optax.chain(clip_by_global_norm(clip), adamw | adam | sgd)
    tx = jax_build_optimizer(JaxOptimConfig(flatten=False, **kw))
    jp = to_jax(params)
    state = tx.init(jp)
    leaves, treedef = jax.tree.flatten(params)
    masters = [t(a).clone() for a in leaves]
    opt = Optimizer(OptimConfig(**kw), masters)
    for g in grads:
        upd, state = tx.update(to_jax(g), state, jp)
        jp = optax.apply_updates(jp, upd)
        opt.step([t(a) for a in jax.tree.leaves(g)])
    # torch.optim orders the same operations differently from optax: about
    # one float32 ulp (1.2e-7 at 1) per update
    for got, want in zip(masters, jax.tree.leaves(jp)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)


def test_clipping_is_optax_rule():
    g = [torch.tensor([3.0, 4.0])]  # norm 5
    for max_norm, want in ((5.0, [3.0, 4.0]), (6.0, [3.0, 4.0]),
                           (1.0, [0.6, 0.8])):
        p = [torch.zeros(2)]
        opt = Optimizer(OptimConfig(optimizer="sgd", lr=1.0, schedule="constant",
                                    grad_clip=max_norm), p)
        opt.step([x.clone() for x in g])
        np.testing.assert_allclose(-p[0].numpy(), want, rtol=1e-6)


# ---------------------------------------------------- one step vs JAX


def random_flax_params(model, batch, seed):
    """Flax params for ``model``: shapes from jax.eval_shape of its init,
    kernels ~ N(0, 1/fan_in), biases ~ N(0, 0.01)."""
    shapes = jax.eval_shape(
        model.init, jax.random.PRNGKey(0),
        *[batch[k] for k in ("left", "right", "temporal")])["params"]
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        if path[-1].key == "kernel":
            fan_in = int(np.prod(leaf.shape[:-1]))
            return (rng.randn(*leaf.shape) / np.sqrt(fan_in)).astype(np.float32)
        return (0.1 * rng.randn(*leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.fixture(scope="module")
def jax_step():
    """One step of the tiny JAX experiment (Pallas correlations in
    interpret mode): params, batch, loss components, gradients and the
    params after one update, as Trainer._loss_fn and the optimizer of
    build_optimizer compute them."""
    cfg = JaxConfig.from_dict(tiny_config_dict("pallas"))
    model, forward, _ = jax_build_model(cfg.model)
    ds = JaxSynthetic(length=2, hw=(64, 64), num_classes=19)
    batch = jax_collate([ds[0], ds[1]])
    prep = make_preprocess_fn(out_hw=(64, 64))(batch)
    params = random_flax_params(model, prep, 1)

    def loss_fn(p, b):
        return jl.joint_loss(forward({"params": p}, b), b,
                             weights=cfg.loss.weights)

    (_, comps), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params, prep)
    tx = jax_build_optimizer(cfg.optim)

    def update(p, g):  # one compile, not one per eager op and leaf
        upd, _ = tx.update(g, tx.init(p), p)
        return optax.apply_updates(p, upd)

    new = jax.jit(update)(params, grads)
    as_np = lambda tree: jax.tree.map(np.asarray, tree)  # noqa: E731
    return (as_np(params), batch, {k: float(v) for k, v in comps.items()},
            as_np(grads), as_np(new))


@pytest.fixture(scope="module")
def port_step(jax_step):
    params, batch, _, _, _ = jax_step
    tr = Trainer(ExperimentConfig.from_dict(tiny_config_dict("pallas")),
                 device="cpu")
    ref = load_flax_params(CerberusNet(num_classes=19, **TINY), params)
    tr.load_masters(dict(ref.named_parameters()))
    comps, grads = tr.loss_and_grads(batch)
    tr.apply_grads(grads)
    return tr, comps, grads


def as_named(tree):
    """A flax tree laid out as the port's parameters, by name."""
    model = load_flax_params(CerberusNet(num_classes=19, **TINY), tree)
    return {n: p.detach().numpy() for n, p in model.named_parameters()}


class TestOneStepAgainstJax:
    def test_loss_components(self, jax_step, port_step):
        _, _, want, _, _ = jax_step
        _, got, _ = port_step
        assert sorted(got) == sorted(want)
        for k in want:
            assert_rel(got[k], want[k], tol=1e-5, what=k)

    def test_gradients(self, jax_step, port_step):
        want = as_named(jax_step[3])
        _, _, grads = port_step
        assert sorted(grads) == sorted(want)
        for name, g in grads.items():
            assert g.dtype == torch.float32
            assert rel(g.numpy(), want[name]) <= 1e-4, name

    def test_parameters_after_one_adamw_step(self, jax_step, port_step):
        want = as_named(jax_step[4])
        before = as_named(jax_step[0])
        tr, _, _ = port_step
        moved = 0
        for name, m in tr.masters.items():
            assert rel(m.numpy(), want[name]) <= 1e-4, name
            moved += not np.array_equal(m.numpy(), before[name])
        assert moved == len(want)
        for name, p in tr.model.named_parameters():
            np.testing.assert_array_equal(p.detach().numpy(),
                                          tr.masters[name].numpy())


# ------------------------------------------------------------- trainer


def tiny_trainer(dtype="float32", **optim):
    return train_entry(
        device="cpu", model={**TINY, "dtype": dtype}, data={"hw": [64, 64]},
        optim={"schedule": "constant", "lr": 2e-3, **optim})


def test_loss_decreases_overfitting_one_batch():
    tr, (batch,) = tiny_trainer()
    totals = [float(tr.train_step(batch)["total"]) for _ in range(10)]
    assert np.all(np.isfinite(totals))
    assert totals[-1] < 0.8 * totals[0], totals


def test_bf16_trainer_keeps_f32_masters():
    tr, (batch,) = tiny_trainer("bfloat16")
    assert tr.model.dtype == torch.bfloat16
    assert tr.model.segmentation.classifier.weight.dtype == torch.float32
    before = {n: m.clone() for n, m in tr.masters.items()}
    comps = tr.train_step(batch)
    assert all(torch.isfinite(v) for v in comps.values())
    for n, m in tr.masters.items():
        assert m.dtype == torch.float32
        assert not torch.equal(m, before[n]), n
        p = dict(tr.model.named_parameters())[n]
        torch.testing.assert_close(p.detach().float(), m.to(p.dtype).float(),
                                   rtol=0, atol=0)


def test_first_warmup_step_changes_nothing():
    tr, (batch,) = tiny_trainer(schedule="cosine", warmup_steps=3,
                                total_steps=10)
    before = {n: m.clone() for n, m in tr.masters.items()}
    tr.train_step(batch)
    for n, m in tr.masters.items():
        assert torch.equal(m, before[n]), n
    tr.train_step(batch)
    assert any(not torch.equal(m, before[n]) for n, m in tr.masters.items())


def test_train_entry_reads_the_synthetic_config():
    tr, bs = train_entry(device="cpu", n_batches=2, corr_impl="plain",
                         model={**TINY}, data={"hw": [64, 64]})
    cfg = json.loads((REPO_ROOT / "configs" / "cerberus_synthetic.json")
                     .read_text())
    assert tr.config.name == cfg["name"]
    assert tr.config.data.batch_size == 2
    assert tr.dtype == torch.bfloat16 and tr.corr_impl == "plain"
    assert len(bs) == 2 and bs[1]["left"].shape == (2, 64, 64, 3)
    np.testing.assert_array_equal(bs[1]["left"][0], tr.dataset[2]["left"])


def test_trainer_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the trainer runs there")
    cfg = ExperimentConfig.from_dict(tiny_config_dict())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(cfg)

"""The port's RMI, photometric and smoothness losses
(cerberusnet_torch/train/losses.py) against the JAX package on the CPU.

* ``rmi_loss`` (pooled or not, labels with ignored pixels),
  ``photometric_loss`` and ``smoothness_loss`` in float32: values within
  1e-5 relative, gradients with respect to every input within 1e-4
  relative L2. ``photometric_loss`` on bf16 frames and flow (warped in
  bf16, compared in float32, as the reference does): the value within
  1e-5, and each bf16 gradient's distance from JAX's float32 gradient
  within twice JAX's bf16 distance plus 1e-3 (test_torch_raft.py's bf16
  rule: a bf16 gradient sums in bf16, so its rounding is the order's). A
  conditional covariance that is not positive definite gives NaN in both.
* ``joint_loss`` with all three weights: the components (seg as (1 - w)
  CE + w RMI, rmi, photometric, smoothness), the total and the gradients
  with respect to the outputs.
* One tiny CerberusNet Trainer step with the three weights on the JAX
  Trainer's weights: its loss components and gradients against the JAX
  Trainer's ``_loss_fn`` (1e-5, 1e-4 per parameter) and its masters after
  one AdamW update against optax's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cerberusnet_torch.testing import one_torch_thread  # noqa: F401
from cerberusnet_torch.train import losses as tl
from cerberusnet_torch.train.config import ExperimentConfig
from cerberusnet_torch.train.trainer import Trainer
from cerberusnet_tpu.data.loader import collate as jax_collate
from cerberusnet_tpu.data.synthetic import SyntheticPerceptionDataset
from cerberusnet_tpu.train import losses as jl
from tests.jax_pairs import draw_params, numpy_tree, port_masters

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def assert_value(got, want, tol=1e-5):
    got, want = float(got), float(want)
    assert abs(got - want) <= tol * max(abs(want), 1e-30), (got, want)


def both(fn_jax, fn_port, arrays, dtype="float32", ints=()):
    """(JAX value, JAX gradients, port value, port gradients) of a scalar
    function of ``arrays`` (numpy), differentiated with respect to every
    array not named in ``ints``."""
    jd, td = DTYPES[dtype]
    names = [k for k in arrays if k not in ints]

    def jax_fn(diff):
        full = {**{k: jnp.asarray(arrays[k]) for k in ints}, **diff}
        return fn_jax(**full)

    jv, jg = jax.value_and_grad(jax_fn)(
        {k: jnp.asarray(arrays[k], jd) for k in names})
    tin = {k: torch.from_numpy(arrays[k]).to(td).requires_grad_()
           for k in names}
    tv = fn_port(**tin, **{k: torch.from_numpy(arrays[k]).long()
                           for k in ints})
    tv.backward()
    return (float(jv), {k: np.asarray(jg[k], np.float32) for k in names},
            float(tv.detach()),
            {k: tin[k].grad.float().numpy() for k in names})


def seg_inputs(b, h, w, c, seed):
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, c, (b, h, w))
    labels[rng.rand(b, h, w) < 0.2] = 255
    return {"logits": (rng.randn(b, h, w, c) * 2).astype(np.float32),
            "labels": labels.astype(np.int32)}


@pytest.mark.parametrize("shape,kw", [
    ((2, 32, 48, 5), {}), ((1, 20, 28, 3), {"pool_stride": 1}),
    ((2, 27, 45, 4), {"pool_stride": 2, "radius": 2})])
def test_rmi_loss_value_and_gradient(shape, kw):
    arrays = seg_inputs(*shape, seed=sum(shape))
    jv, jg, tv, tg = both(lambda logits, labels: jl.rmi_loss(logits, labels,
                                                             **kw),
                          lambda logits, labels: tl.rmi_loss(logits, labels,
                                                             **kw),
                          arrays, ints=("labels",))
    assert np.isfinite(tv)
    assert_value(tv, jv)
    assert rel(tg["logits"], jg["logits"]) <= 1e-4


def test_rmi_loss_not_positive_definite_is_nan_in_both():
    arrays = seg_inputs(1, 16, 16, 3, seed=1)
    want = jl.rmi_loss(jnp.asarray(arrays["logits"]),
                       jnp.asarray(arrays["labels"]), eps=-1.0)
    got = tl.rmi_loss(torch.from_numpy(arrays["logits"]),
                      torch.from_numpy(arrays["labels"]).long(), eps=-1.0)
    assert np.isnan(float(want)) and np.isnan(float(got))


def photo_inputs(seed, b=2, h=16, w=24):
    rng = np.random.RandomState(seed)
    return {"im1": rng.randn(b, h, w, 3).astype(np.float32),
            "im2": rng.randn(b, h, w, 3).astype(np.float32),
            "flow": (rng.randn(b, h, w, 2) * 3).astype(np.float32)}


def test_photometric_loss_value_and_gradients():
    jv, jg, tv, tg = both(jl.photometric_loss, tl.photometric_loss,
                          photo_inputs(2))
    assert_value(tv, jv)
    for k in jg:
        assert rel(tg[k], jg[k]) <= 1e-4, (k, rel(tg[k], jg[k]))


def test_photometric_loss_in_bfloat16():
    _, j32, _, _ = both(jl.photometric_loss, tl.photometric_loss,
                        photo_inputs(2))
    jv, j16, tv, t16 = both(jl.photometric_loss, tl.photometric_loss,
                            photo_inputs(2), "bfloat16")
    assert_value(tv, jv)
    for k in j32:
        jax_gap, port_gap = rel(j16[k], j32[k]), rel(t16[k], j32[k])
        assert port_gap <= 2 * jax_gap + 1e-3, (k, port_gap, jax_gap)


def test_ssim_of_identical_images_is_one():
    x = torch.from_numpy(photo_inputs(3)["im1"])
    assert abs(float(tl._ssim(x, x)) - 1.0) < 1e-6
    assert_value(tl._ssim(x, x * 0.5 + 0.1),
                 jl._ssim(jnp.asarray(x.numpy()),
                          jnp.asarray(x.numpy() * 0.5 + 0.1)))


def test_smoothness_loss_value_and_gradients():
    rng = np.random.RandomState(4)
    arrays = {"field": rng.randn(2, 16, 24, 2).astype(np.float32),
              "image": rng.randn(2, 16, 24, 3).astype(np.float32)}
    jv, jg, tv, tg = both(jl.smoothness_loss, tl.smoothness_loss, arrays)
    assert_value(tv, jv)
    for k in jg:
        assert rel(tg[k], jg[k]) <= 1e-4, k


def test_joint_loss_with_the_auxiliary_terms():
    rng = np.random.RandomState(5)
    b, h, w = 2, 32, 48
    seg = seg_inputs(b, h, w, 5, seed=6)
    out = {
        "seg_logits": seg["logits"],
        "flow": (rng.randn(b, h, w, 2) * 2).astype(np.float32),
        "flow_pyramid": {lv: rng.randn(b, h >> lv, w >> lv, 2).astype(
            np.float32) for lv in (2, 3)},
        "disp_pyramid": {lv: (rng.rand(b, h >> lv, w >> lv, 1) * 3).astype(
            np.float32) for lv in (2, 3)},
    }
    batch = {
        "seg_labels": seg["labels"],
        "flow_gt": (rng.randn(b, h, w, 2) * 4).astype(np.float32),
        "flow_valid": (rng.rand(b, h, w) < 0.5).astype(np.float32),
        "disp_gt": (rng.rand(b, h, w) * 20).astype(np.float32),
        "left": rng.randn(b, h, w, 3).astype(np.float32),
        "temporal": rng.randn(b, h, w, 3).astype(np.float32),
    }
    kw = dict(weights={"seg": 1.0, "flow": 0.5, "disp": 2.0}, rmi_weight=0.3,
              photometric_weight=0.1, smoothness_weight=0.2)

    def jax_total(o):
        return jl.joint_loss(o, jax.tree.map(jnp.asarray, batch), **kw)

    (_, jcomps), jgrads = jax.value_and_grad(jax_total, has_aux=True)(
        jax.tree.map(jnp.asarray, out))
    tout = jax.tree.map(lambda a: torch.from_numpy(a).requires_grad_(), out)
    tbatch = {k: torch.from_numpy(v).long() if k == "seg_labels"
              else torch.from_numpy(v) for k, v in batch.items()}
    ttotal, tcomps = tl.joint_loss(tout, tbatch, **kw)
    assert sorted(tcomps) == sorted(jcomps) == [
        "disp", "flow", "photometric", "rmi", "seg", "smoothness", "total"]
    for k in jcomps:
        assert_value(tcomps[k].detach(), jcomps[k])
    ttotal.backward()
    for leaf, want in zip(jax.tree.leaves(tout), jax.tree.leaves(jgrads)):
        assert rel(leaf.grad.numpy(), want) <= 1e-4


# ------------------------------------------------------- a trainer step

CONFIG = {
    "name": "tiny-aux",
    "model": {"variant": "cerberus", "encoder_channels": [8, 12, 16, 16, 16, 16],
              "est_channels": [16, 16, 12], "ctx_channels": [16, 16],
              "fpn_channels": 16, "corr_impl": "pure"},
    "data": {"dataset": "synthetic", "hw": [64, 64], "batch_size": 2,
             "num_workers": 1, "synthetic_length": 2, "shuffle": False},
    "optim": {"lr": 2e-3, "warmup_steps": 0, "total_steps": 100,
              "schedule": "constant"},
    "loss": {"rmi_weight": 0.5, "photometric_weight": 0.1,
             "smoothness_weight": 0.1},
    "train": {"num_data_devices": 1},
}


@pytest.fixture(scope="module")
def steps():
    """The JAX Trainer's loss components, gradients and AdamW update on
    random weights, and the port Trainer's step from the same weights and
    batch."""
    from cerberusnet_tpu.train.config import ExperimentConfig as JaxConfig
    from cerberusnet_tpu.train.trainer import Trainer as JaxTrainer
    from cerberusnet_tpu.train.trainer import build_optimizer

    jt = JaxTrainer(JaxConfig.from_dict(CONFIG))
    params = draw_params(jax.eval_shape(lambda: jt.state.params), 13)
    ds = SyntheticPerceptionDataset(length=2, hw=(64, 64), num_classes=19)
    batch = jax_collate([ds[0], ds[1]])
    (_, comps), grads = jax.jit(jax.value_and_grad(jt._loss_fn, has_aux=True))(
        jax.tree.map(jnp.asarray, params), jt.preprocess(batch))
    tx = build_optimizer(jt.config.optim)

    def update(p, g):
        upd, _ = tx.update(g, tx.init(p), p)
        return optax.apply_updates(p, upd)

    new = jax.jit(update)(params, grads)
    cfg = ExperimentConfig.from_dict(CONFIG)
    tr = Trainer(cfg, device="cpu")
    tr.load_masters(port_masters(cfg, params))
    got, got_grads = tr.loss_and_grads(batch)
    tr.apply_grads(got_grads)
    return (cfg, {k: float(v) for k, v in comps.items()},
            port_masters(cfg, numpy_tree(grads)),
            port_masters(cfg, numpy_tree(new)), got, got_grads, tr)


def test_trainer_loss_components_equal_jax(steps):
    _, want, _, _, got, _, _ = steps
    assert sorted(got) == sorted(want) == [
        "disp", "flow", "photometric", "rmi", "seg", "smoothness", "total"]
    for k in want:
        assert_value(got[k], want[k])


def test_trainer_gradients_equal_jax(steps):
    _, _, want, _, _, grads, _ = steps
    assert sorted(grads) == sorted(want)
    for name, g in grads.items():
        assert rel(g.numpy(), want[name].numpy()) <= 1e-4, name


def test_trainer_update_equals_optax(steps):
    _, _, _, want, _, _, tr = steps
    for name, m in tr.masters.items():
        assert rel(m.numpy(), want[name].numpy()) <= 1e-4, name

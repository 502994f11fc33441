"""The port's DCV family (cerberusnet_torch.models.dcv_flow) and its
dilated correlations against the JAX package, on the CPU.

* The correlations at dilation: the 2-D op against the reference's
  W-in-lanes Pallas kernel (``correlation2d_wl``, interpret mode) at
  dilations 1, 2 and 4; the 1-D op against ``correlation1d_wl`` at
  dilation 1 and against ``_correlation1d_pure`` at 2 and 3 (the reference's
  1-D Pallas kernel takes dilation 1 only). float32 within summation order
  (rtol 1e-5, atol 1e-6); bfloat16 within one bf16 ulp, since both sides
  sum in float32 and round once.
* ``DCVFlowNet``, ``DCVStereoNet`` and ``CerberusDCV`` at tiny widths,
  loaded from random flax parameters with ``load_flax_params``, against
  the JAX models (``corr_impl="pure"``, ``fused=True``): every output and
  the one-level pyramids within 1e-4 of max(max|JAX|, 1) in float32.
* One train step's loss and gradients of the tiny ``cerberus_dcv``
  experiment with uncertainty weighting, the port's ``Trainer`` against
  ``jax.value_and_grad`` of the JAX model, ``joint_loss`` and
  ``uncertainty_weighted_total``, the three log-variances' gradients
  included: loss components within 1e-5 relative, every gradient within
  1e-4 relative L2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cerberusnet_tpu.data.loader import collate as jax_collate
from cerberusnet_tpu.data.loader import make_preprocess_fn
from cerberusnet_tpu.data.synthetic import (
    SyntheticPerceptionDataset as JaxSynthetic,
)
from cerberusnet_tpu.models import dcv_flow as jdcv
from cerberusnet_tpu.ops.correlation import _correlation1d_pure
from cerberusnet_tpu.ops.pallas.correlation import (
    correlation1d_wl,
    correlation2d_wl,
)
from cerberusnet_tpu.train import losses as jl
from cerberusnet_tpu.train.config import ExperimentConfig as JaxConfig
from cerberusnet_tpu.train.trainer import build_model as jax_build_model
from cerberusnet_torch.models import dcv_flow as tdcv
from cerberusnet_torch.ops.correlation import correlation1d, correlation2d
from cerberusnet_torch.train.config import ExperimentConfig
from cerberusnet_torch.train.trainer import UNCERTAINTY, Trainer
from cerberusnet_torch.testing import one_torch_thread  # noqa: F401
from cerberusnet_torch.weights import load_flax_params



# tests/test_models.py::TestCerberusDCV's tiny widths
TINY = dict(encoder_channels=(8, 12, 16, 16, 16, 16), est_channels=(16, 12),
            ctx_channels=(16,))
HW = (48, 80)  # level 3: 6 x 10
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def bf16_ulp(x):
    mag = np.maximum(np.abs(x), np.float32(2.0**-126))
    return np.exp2(np.floor(np.log2(mag)) - 7)


def feature_pair(shape, dtype, seed=0):
    """Two feature maps as (jax, torch) pairs holding identical values."""
    rng = np.random.RandomState(seed)
    jdt, tdt = DTYPES[dtype]
    out = []
    for _ in range(2):
        j = jnp.asarray(rng.randn(*shape).astype(np.float32), jdt)
        out.append((j, torch.from_numpy(np.array(j, np.float32)).to(tdt)))
    return out


# (op, dilation, reference); shapes as the DCV heads see them, odd sizes
CORR_CASES = [("2d", 1, "wl"), ("2d", 2, "wl"), ("2d", 4, "wl"),
              ("1d", 1, "wl"), ("1d", 2, "pure"), ("1d", 3, "pure")]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("op,dilation,ref", CORR_CASES,
                         ids=[f"{o}-dil{d}-{r}" for o, d, r in CORR_CASES])
def test_dilated_correlation_matches_jax(op, dilation, ref, dtype):
    shape = (1, 9, 13, 8) if op == "2d" else (2, 5, 30, 8)
    (j1, t1), (j2, t2) = feature_pair(shape, dtype)
    if op == "2d":
        want = correlation2d_wl(j1, j2, 4, True, dilation)
        got = correlation2d(t1, t2, 4, dilation)
    else:
        want = (correlation1d_wl(j1, j2, 4, True) if ref == "wl"
                else _correlation1d_pure(j1, j2, 4, dilation))
        got = correlation1d(t1, t2, 4, dilation)
    assert got.dtype == DTYPES[dtype][1]
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape == shape[:3] + (
        81 if op == "2d" else 5,)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    else:
        gap = np.abs(got - want)
        assert np.all(gap <= np.maximum(bf16_ulp(got), bf16_ulp(want))), (
            f"more than one bf16 ulp apart: max gap {gap.max()}")


# ---------------------------------------------------------------- models


def frames(seed, n):
    rng = np.random.RandomState(seed)
    return [rng.rand(1, *HW, 3).astype(np.float32) for _ in range(n)]


def random_params(model, imgs, seed):
    """A flax param tree for ``model`` with numpy values drawn at realistic
    scales (kernels ~ N(0, 1/fan_in), biases ~ N(0, 0.01))."""
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            *[jnp.asarray(i) for i in imgs])["params"]
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        if path[-1].key == "kernel":
            fan_in = int(np.prod(leaf.shape[:-1]))
            return (rng.randn(*leaf.shape) / np.sqrt(fan_in)).astype(np.float32)
        return (0.1 * rng.randn(*leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def flat(out):
    """Output dict -> {name: float32 numpy array}, pyramids by level."""
    res = {}
    for key, v in out.items():
        for level, t in (v.items() if isinstance(v, dict) else [(None, v)]):
            name = key if level is None else f"{key}[{level}]"
            res[name] = (t.detach().float().numpy()
                         if isinstance(t, torch.Tensor)
                         else np.asarray(t, np.float32))
    return res


# name: (JAX model, port model, frames it takes, output keys)
MODELS = {
    "DCVFlowNet": (
        jdcv.DCVFlowNet(dilations=(1, 2), corr_impl="pure", fused=True,
                        **TINY),
        lambda: tdcv.DCVFlowNet(dilations=(1, 2), **TINY), 2,
        ["flow", "flow_pyramid[3]"]),
    "DCVStereoNet": (
        jdcv.DCVStereoNet(dilations=(1, 2), corr_impl="pure", fused=True,
                          **TINY),
        lambda: tdcv.DCVStereoNet(dilations=(1, 2), **TINY), 2,
        ["disp", "disp_pyramid[3]"]),
    "CerberusDCV": (
        jdcv.CerberusDCV(flow_dilations=(1, 2), disp_dilations=(1, 2),
                         fpn_channels=16, corr_impl="pure", fused=True,
                         **TINY),
        lambda: tdcv.CerberusDCV(flow_dilations=(1, 2), disp_dilations=(1, 2),
                                 fpn_channels=16, **TINY), 3,
        ["disp", "disp_pyramid[3]", "flow", "flow_pyramid[3]",
         "seg_logits"]),
}


@pytest.mark.parametrize("name", list(MODELS))
def test_model_matches_jax(name):
    jmodel, make_port, n_frames, keys = MODELS[name]
    imgs = frames(1, n_frames)
    params = random_params(jmodel, imgs, 2)
    want = flat(jax.jit(lambda p, *x: jmodel.apply({"params": p}, *x))(
        params, *[jnp.asarray(i) for i in imgs]))
    port = load_flax_params(make_port().eval(), params)
    with torch.no_grad():
        got = flat(port(*[torch.from_numpy(i) for i in imgs]))
    assert sorted(got) == sorted(want) == sorted(keys)
    for key in keys:
        assert got[key].shape == want[key].shape, key
        err = np.abs(got[key] - want[key]).max() / max(
            np.abs(want[key]).max(), 1.0)
        assert err <= 1e-4, f"{name} {key}: relative max error {err}"


def test_joint_outputs_cast_to_f32():
    model = tdcv.CerberusDCV(fpn_channels=16, dtype=torch.bfloat16, **TINY)
    assert model.segmentation.classifier.weight.dtype == torch.float32
    with torch.no_grad():
        out = model(*[torch.from_numpy(i) for i in frames(0, 3)])
    assert out["flow"].dtype == out["disp"].dtype == torch.float32
    assert out["flow_pyramid"][3].dtype == torch.bfloat16
    assert tuple(out["flow_pyramid"][3].shape) == (1, HW[0] // 8,
                                                   HW[1] // 8, 2)


# ---------------------------------------------- one train step vs JAX

LOG_VARS = {"seg": 0.3, "flow": -0.2, "disp": 0.1}


def dcv_config_dict():
    """configs/cerberus_dcv.json at tiny widths and size: its variant and
    uncertainty weighting, the reference's default dilations."""
    return {
        "name": "tiny-dcv",
        "model": {"variant": "cerberus_dcv", "corr_impl": "purev",
                  "fpn_channels": 16,
                  **{k: list(v) for k, v in TINY.items()}},
        "data": {"dataset": "synthetic", "hw": [32, 64], "batch_size": 2,
                 "synthetic_length": 2},
        "optim": {"schedule": "constant"},
        "loss": {"uncertainty_weighting": True},
        "train": {"num_data_devices": 1},
    }


@pytest.fixture(scope="module")
def dcv_step():
    """The tiny DCV experiment's loss and gradients from the same weights
    and batch, in JAX (as ``Trainer._loss_fn`` computes them) and in the
    port's Trainer: ((JAX comps, grads), (port comps, grads), names)."""
    cfg = JaxConfig.from_dict(dcv_config_dict())
    model, forward, _ = jax_build_model(cfg.model)
    ds = JaxSynthetic(length=2, hw=(32, 64), num_classes=19)
    batch = jax_collate([ds[0], ds[1]])
    prep = make_preprocess_fn(out_hw=(32, 64))(batch)
    params = random_params(model, [prep[k] for k in ("left", "right",
                                                     "temporal")], 3)

    def loss_fn(p, lv, b):
        total, comps = jl.joint_loss(forward({"params": p}, b), b,
                                     weights=cfg.loss.weights)
        total = jl.uncertainty_weighted_total(comps, lv)
        return total, {**comps, "total": total}

    lv = {t: jnp.float32(v) for t, v in LOG_VARS.items()}
    (_, comps), grads = jax.jit(jax.value_and_grad(
        loss_fn, argnums=(0, 1), has_aux=True))(params, lv, prep)

    tr = Trainer(ExperimentConfig.from_dict(dcv_config_dict()), device="cpu")
    ref = load_flax_params(tdcv.CerberusDCV(fpn_channels=16, **TINY), params)
    masters = dict(ref.named_parameters())
    masters.update({f"{UNCERTAINTY}.{t}": torch.tensor(v)
                    for t, v in LOG_VARS.items()})
    tr.load_masters(masters)
    tcomps, tgrads = tr.loss_and_grads(batch)

    named = {n: p.detach().numpy() for n, p in load_flax_params(
        tdcv.CerberusDCV(fpn_channels=16, **TINY),
        jax.tree.map(np.array, grads[0])).named_parameters()}
    named.update({f"{UNCERTAINTY}.{t}": np.asarray(g)
                  for t, g in grads[1].items()})
    return ({k: float(v) for k, v in comps.items()}, named), (tcomps, tgrads)


def test_uncertainty_weighted_loss_matches_jax(dcv_step):
    (want, _), (got, _) = dcv_step
    assert sorted(got) == sorted(want) == ["disp", "flow", "seg", "total"]
    for k, v in want.items():
        assert abs(float(got[k]) - v) <= 1e-5 * abs(v), (k, float(got[k]), v)
    weighted = sum(np.exp(-s) * want[t] + 0.5 * s for t, s in LOG_VARS.items())
    assert want["total"] == pytest.approx(weighted, rel=1e-5)


def test_gradients_match_jax(dcv_step):
    (_, want), (_, got) = dcv_step
    assert sorted(got) == sorted(want)
    assert len([n for n in got if n.startswith(UNCERTAINTY)]) == 3
    for name, g in got.items():
        assert g.dtype == torch.float32
        a, b = g.numpy().astype(np.float64), want[name].astype(np.float64)
        err = np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)
        assert err <= 1e-4, (name, err)


# ------------------------------------------------- variants and entries


@pytest.mark.parametrize("variant,keys,comps", [
    ("cerberus_dcv", ("left", "right", "temporal"),
     ["disp", "flow", "seg", "total"]),
    ("dcv_flow", ("left", "temporal"), ["flow", "total"]),
    ("dcv_stereo", ("left", "right"), ["disp", "total"]),
])
def test_trainer_builds_each_dcv_variant(variant, keys, comps):
    raw = dcv_config_dict()
    raw["model"]["variant"] = variant
    tr = Trainer(ExperimentConfig.from_dict(raw), device="cpu")
    assert tr.input_keys == keys
    assert len([n for n in tr.masters if n.startswith(UNCERTAINTY)]) == 3
    batch = tr.dataset[0]
    batch = {k: np.stack([v, tr.dataset[1][k]]) for k, v in batch.items()}
    before = {n: m.clone() for n, m in tr.masters.items()}
    got = tr.train_step(batch)
    assert sorted(got) == comps
    assert all(torch.isfinite(v) for v in got.values())
    # the log-variance of a task the model has no head for gets no
    # gradient, and from 0 no weight decay either: it stays at 0
    for t in ("seg", "flow", "disp"):
        moved = not torch.equal(tr.masters[f"{UNCERTAINTY}.{t}"],
                                before[f"{UNCERTAINTY}.{t}"])
        assert moved == (t in comps), t


def test_entry_serves_cerberus_dcv_on_cpu():
    from cerberusnet_torch.entry import entry

    forward, imgs = entry(device="cpu", dtype=torch.float32, hw=(64, 64),
                          variant="cerberus_dcv")
    out = forward(*imgs)
    assert tuple(out["seg_logits"].shape) == (1, 64, 64, 19)
    assert tuple(out["flow"].shape) == (1, 64, 64, 2)
    assert sorted(out["disp_pyramid"]) == [3]
    with pytest.raises(ValueError, match="unknown variant"):
        entry(device="cpu", variant="raft")


def test_missing_dcv_parameter_raises():
    jmodel = MODELS["DCVFlowNet"][0]
    params = dict(random_params(jmodel, frames(0, 2), 0))
    dec = dict(params["DCVFlowDecoder_0"])
    del dec["ContextNetwork_0"]
    params["DCVFlowDecoder_0"] = dec
    with pytest.raises(KeyError):
        load_flax_params(MODELS["DCVFlowNet"][1](), params)

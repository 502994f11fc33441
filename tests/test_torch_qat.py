"""The port's QAT (cerberusnet_torch/quant/qat.py and the trainer's
``train.qat``) against the JAX package's (cerberusnet_tpu/quant/qat.py and
its trainer's fake-quant forward) on the CPU, with the same weights and
numpy batches.

Tolerances: fake quantization repeats PTQ's arithmetic in float32, so the
heads and the observed ranges differ by summation order and the rare
activation it moves across a rounding step (1e-4 relative L2, 1e-5 on a
range); the EMA's arithmetic is the same float32 expression (1e-7). One
QAT train step of the tiny model: the losses within 1e-5 relative and each
module's gradients within 5e-2 relative L2, looser than the float step's
1e-4 (tests/test_torch_train.py): a fake-quantized input that crosses a
rounding step moves by a whole int8 step, and a gradient sums every such
move downstream. The port's own step shows the scale: its ranges scaled by
1 + 3e-7 move its stem's gradient by 1.9e-2 and the next two blocks' by
5.7e-3 and 4.4e-3; against JAX the modules read up to 6.1e-3 (the stem)
run alone and 1.3e-2 (the flow head's finest estimator) run under
pytest-xdist beside other test files. A missing or wrong straight-through
gradient moves a module by order 1.
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
from cerberusnet_tpu.models import CerberusNet as JaxCerberusNet
from cerberusnet_tpu.quant import calibrate as jax_calibrate
from cerberusnet_tpu.quant import finalize as jax_finalize
from cerberusnet_tpu.quant import init_ema as jax_init_ema
from cerberusnet_tpu.quant import qat_apply as jax_qat_apply
from cerberusnet_tpu.quant import quantized_apply as jax_quantized_apply
from cerberusnet_tpu.quant import update_ema as jax_update_ema
from cerberusnet_tpu.quant.ptq import _flatten
from cerberusnet_tpu.quant.qat import EMA_COLLECTION, qat_interception
from cerberusnet_tpu.quant.qat import _ste_round_clip as jax_ste
from cerberusnet_tpu.train import losses as jl
from cerberusnet_tpu.train.config import ExperimentConfig as JaxConfig
from cerberusnet_tpu.train.trainer import build_model as jax_build_model
from cerberusnet_torch.models.cerberus import CerberusNet
from cerberusnet_torch.quant import (
    calibrate,
    finalize,
    init_ema,
    qat_apply,
    quantize,
    quantized_apply,
    update_ema,
)
from cerberusnet_torch.quant.ptq import rel_l2
from cerberusnet_torch.quant.qat import _ste_round_clip
from cerberusnet_torch.testing import one_torch_thread  # noqa: F401
from cerberusnet_torch.train.config import ExperimentConfig
from cerberusnet_torch.train.trainer import Trainer
from cerberusnet_torch.weights import flax_conv_paths, load_flax_params
from tools.torch_baseline import TorchCerberus

TINY = dict(encoder_channels=(8, 12, 16, 16, 16, 16), est_channels=(16, 16, 12),
            ctx_channels=(16, 16), fpn_channels=16)
HW = (64, 64)
HEADS = ("seg_logits", "flow", "disp")


def frames(seed):
    rng = np.random.RandomState(seed)
    return tuple(rng.rand(1, *HW, 3).astype(np.float32) for _ in range(3))


def as_torch(batch):
    return tuple(torch.from_numpy(x) for x in batch)


def port_model(params):
    """The port's tiny model in the JAX side's form: naive estimators
    (``fused=False``), whose convs the interception sees."""
    return load_flax_params(CerberusNet(**TINY, fused=False), params).eval()


def by_path(ema: dict, paths: dict) -> dict:
    """A port range dict keyed by the reference's flax paths."""
    return {paths[n]: float(v) for n, v in ema.items()}


def jax_ranges(tree) -> dict:
    return {k[:-1]: float(np.asarray(v).reshape(()))
            for k, v in _flatten(tree).items()}


# ------------------------------------------------------------------ STE


@pytest.mark.parametrize("scale", [1.0, 0.1])
def test_ste_values_and_identity_gradient(scale):
    x = np.asarray([0.0, 0.04, 0.4, 1.0, -2.0, 200.0, -1e3, 0.05, 0.15],
                   np.float32)
    want = np.asarray(jax_ste(jnp.asarray(x), jnp.float32(scale)))
    xt = torch.from_numpy(x).requires_grad_()
    got = _ste_round_clip(xt, torch.tensor(scale))
    np.testing.assert_array_equal(got.detach().numpy(), want)
    got.sum().backward()
    jgrad = jax.grad(lambda v: jnp.sum(jax_ste(v, jnp.float32(scale))))(
        jnp.asarray(x))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(jgrad))
    np.testing.assert_array_equal(xt.grad.numpy(), np.ones_like(x))


# ------------------------------------------------------- forward, EMA


@pytest.fixture(scope="module")
def jax_side():
    """The tiny unfused JAX model, its weights and ranges (calibrated on two
    batches), and qat_apply's heads and observed ranges on a third batch:
    seeded everywhere, and with the classifier's seed left out (the live
    range)."""
    model = JaxCerberusNet(**TINY, corr_impl="pure", fused=False)
    calib = [frames(0), frames(1)]
    variables = jax.jit(model.init)(jax.random.PRNGKey(0), *calib[0])
    scales = jax_calibrate(model, variables, calib)
    run = jax.jit(lambda v, *x: jax_qat_apply(model, v, *x))
    batch = frames(2)
    seeded = jax_init_ema(variables, scales)
    unseeded = jax_init_ema(variables, {
        k: v for k, v in scales.items()
        if k != ("SegmentationHead_0", "Conv_5")})
    outs = {}
    for name, v in (("seeded", seeded), ("unseeded", unseeded)):
        out, observed = run(v, *batch)
        outs[name] = ({k: np.asarray(out[k]) for k in HEADS},
                      jax_ranges(observed))
    qv = jax_finalize(seeded)
    final = jax.jit(lambda v, *x: jax_quantized_apply(model, v, *x))(
        qv, *batch)
    return {"params": jax.tree.map(np.asarray, variables["params"]),
            "scales": scales, "batch": batch, "outs": outs,
            "final": {k: np.asarray(final[k]) for k in HEADS}}


def port_ranges(model, scales, leave_out=()):
    paths = flax_conv_paths(model)
    return init_ema({n: scales[p] for n, p in paths.items()
                     if p in scales and p not in leave_out})


@pytest.mark.parametrize("case", ["seeded", "unseeded"])
@pytest.mark.parametrize("head", HEADS)
def test_qat_apply_matches_jax(case, head, jax_side):
    model = port_model(jax_side["params"])
    ema = port_ranges(model, jax_side["scales"], leave_out=(
        ("SegmentationHead_0", "Conv_5"),) if case == "unseeded" else ())
    with torch.no_grad():
        out, observed = qat_apply(model, ema, *as_torch(jax_side["batch"]))
    want, want_observed = jax_side["outs"][case]
    assert rel_l2(out[head], torch.from_numpy(want[head])) <= 1e-4
    got_observed = by_path(observed, flax_conv_paths(model))
    assert sorted(got_observed) == sorted(want_observed)
    for k, v in want_observed.items():
        assert got_observed[k] == pytest.approx(v, rel=1e-5), k


# (momentum, which conv's observation is left out, which conv's range is
# left out): the rule, survival of an unobserved range, adoption
EMA_CASES = {"momentum": (0.5, None, None),
             "survival": (0.99, "flow.predictors.0", None),
             "adoption": (0.99, None, "encoder.blocks.4.conv")}


@pytest.mark.parametrize("case", EMA_CASES)
def test_update_ema_matches_jax(case, jax_side):
    momentum, unobserved, unseeded = EMA_CASES[case]
    model = port_model(jax_side["params"])
    paths = flax_conv_paths(model)
    ema = port_ranges(model, jax_side["scales"])
    rng = np.random.RandomState(5)
    observed = {n: torch.tensor(float(v) * rng.uniform(0.5, 2.0))
                for n, v in ema.items()}
    observed.pop(unobserved, None)
    ema.pop(unseeded, None)
    got = by_path(update_ema(ema, observed, momentum), paths)

    def tree(values):
        out = {}
        for n, v in values.items():
            node = out
            for key in paths[n]:
                node = node.setdefault(key, {})
            node["in_absmax"] = jnp.asarray(np.float32(v))
        return out

    jax_obs = tree(observed)
    want = jax_ranges(jax_update_ema({EMA_COLLECTION: tree(ema)}, jax_obs,
                                     momentum)[EMA_COLLECTION])
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k] == pytest.approx(v, rel=1e-7), k
    if unobserved:
        assert got[paths[unobserved]] == float(ema[unobserved])
    if unseeded:
        assert got[paths[unseeded]] == float(observed[unseeded])


def test_finalize_feeds_quantized_apply(jax_side):
    """finalize is ptq.quantize with the trained ranges: the same quant
    buffers, and the int8 heads within PTQ's tolerance of JAX's
    finalize -> quantized_apply."""
    model = port_model(jax_side["params"])
    ema = port_ranges(model, jax_side["scales"])
    finalize(model, ema)
    ref = quantize(port_model(jax_side["params"]),
                   {n: float(v) for n, v in ema.items()})
    for (n, a), (_, b) in zip(model.named_buffers(), ref.named_buffers()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=n)
    with torch.no_grad():
        out = quantized_apply(model, *as_torch(jax_side["batch"]))
    for k in HEADS:
        assert rel_l2(out[k], torch.from_numpy(jax_side["final"][k])) <= 1e-4
    with pytest.raises(ValueError, match="no QAT ranges"):
        finalize(model, {})


# ------------------------------------------------------- one train step


def config_dict(qat=True):
    return {
        "name": "tiny-qat",
        "model": {"variant": "cerberus", "corr_impl": "pure",
                  **{k: list(v) if isinstance(v, tuple) else v
                     for k, v in TINY.items()}},
        "data": {"dataset": "synthetic", "hw": list(HW), "batch_size": 2,
                 "num_workers": 1, "synthetic_length": 4, "shuffle": False},
        "optim": {"lr": 2e-3, "warmup_steps": 0, "total_steps": 100,
                  "schedule": "constant"},
        "train": {"num_data_devices": 1, "qat": qat},
    }


@pytest.fixture(scope="module")
def jax_qat_step():
    """The JAX trainer's QAT loss and gradients on the synthetic set's first
    batch: ranges calibrated on its first qat_calib_batches batches with
    the starting weights, the forward under qat_interception (its
    _setup_qat, with the unfused model its QAT forces)."""
    cfg = JaxConfig.from_dict(config_dict())
    cfg.model.fused = False
    model, forward, _ = jax_build_model(cfg.model)
    ds = JaxSynthetic(length=4, hw=HW, num_classes=19)
    prep = make_preprocess_fn(out_hw=HW)
    batches = [prep(jax_collate([ds[2 * i], ds[2 * i + 1]])) for i in (0, 1)]
    keys = ("left", "right", "temporal")
    variables = jax.jit(model.init)(jax.random.PRNGKey(3),
                                    *(batches[0][k][:1] for k in keys))
    scales = jax_calibrate(model, variables,
                           [tuple(b[k] for k in keys) for b in batches])
    ema = jax_init_ema({}, scales)[EMA_COLLECTION]

    def loss_fn(p, b):
        with qat_interception():
            out = forward({"params": p, EMA_COLLECTION: ema}, b)
        return jl.joint_loss(out, b, weights=cfg.loss.weights)

    (_, comps), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"], batches[0])
    as_np = lambda tree: jax.tree.map(np.asarray, tree)  # noqa: E731
    return (as_np(variables["params"]), jax_collate([ds[0], ds[1]]),
            {k: float(v) for k, v in comps.items()}, as_np(grads))


@pytest.fixture(scope="module")
def port_qat_step(jax_qat_step):
    params, batch, _, _ = jax_qat_step
    tr = Trainer(ExperimentConfig.from_dict(config_dict()), device="cpu")
    ref = load_flax_params(CerberusNet(**TINY), params)
    tr.load_masters(dict(ref.named_parameters()))
    tr._qat_ema = tr._calibrate_qat_ranges()  # on the loaded weights
    return tr.loss_and_grads(batch)


def test_qat_step_losses_match_jax(jax_qat_step, port_qat_step):
    want = jax_qat_step[2]
    got, _ = port_qat_step
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert float(got[k]) == pytest.approx(v, rel=1e-5), k


@pytest.mark.parametrize("part", ["encoder", "disparity", "flow",
                                  "segmentation"])
def test_qat_step_gradients_match_jax(part, jax_qat_step, port_qat_step):
    want = load_flax_params(CerberusNet(**TINY), jax_qat_step[3])
    _, grads = port_qat_step
    modules = {}
    for name, p in want.named_parameters():
        if name.startswith(part):
            module = name.rsplit(".", 1)[0]
            modules.setdefault(module, []).append((grads[name], p.detach()))
    assert modules
    for module, pairs in modules.items():
        got = torch.cat([g.flatten() for g, _ in pairs])
        ref = torch.cat([w.flatten() for _, w in pairs])
        assert rel_l2(got, ref) <= 5e-2, module


def test_import_torch_weights_calibrates_again(tmp_path):
    """The ranges follow imported weights: after import_torch_weights they
    equal a calibration of the imported weights, not the seeded ones'."""
    tr = Trainer(ExperimentConfig.from_dict(config_dict()), device="cpu")
    before = {n: float(v) for n, v in tr._qat_ema.items()}
    torch.manual_seed(4)
    mirror = TorchCerberus(enc=TINY["encoder_channels"],
                           est=TINY["est_channels"], ctx=TINY["ctx_channels"],
                           fpn=TINY["fpn_channels"])
    ckpt = str(tmp_path / "mirror.pt")
    torch.save(mirror.state_dict(), ckpt)
    tr.import_torch_weights(ckpt)
    after = {n: float(v) for n, v in tr._qat_ema.items()}
    want = calibrate(tr.model, tr._calib_batches(2, 2))
    assert after == want
    assert sorted(after) == sorted(before) and after != before

"""The port's int8 PTQ (cerberusnet_torch/quant/ptq.py) against the JAX
package's (cerberusnet_tpu/quant/ptq.py) on the tiny joint model, on the
CPU, with the same weights (load_flax_params) and the same numpy batches.

Tolerances: calibration absmaxes are float32 maxima of activations that
differ only by summation order, which adds up over the layers before a
conv: 1e-5 relative (the deepest, the flow head's context network, differ
by 1.1e-6); the int8 kernels and one
conv's int32 sums are integers and must be equal; scale_w and in_scale are
one float32 division of equal inputs, which XLA computes as a product with
the divisor's reciprocal: within one float32 ulp (2^-23 relative). The quantized model's
heads, given the same scales, differ only where a float32 activation that
differs by summation order rounds to another int8 step: 1e-4 relative L2 at
most, far below the int8 error itself (0.2 / 0.35 in tests/test_quant.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cerberusnet_tpu.models import CerberusNet as JaxCerberusNet
from cerberusnet_tpu.quant import calibrate as jax_calibrate
from cerberusnet_tpu.quant import quantize as jax_quantize
from cerberusnet_tpu.quant import quantized_apply as jax_quantized_apply
from cerberusnet_tpu.quant.ptq import QUANT_COLLECTION, _flatten
from cerberusnet_torch.models.cerberus import CerberusNet
from cerberusnet_torch.quant import (
    calibrate,
    quantization_error,
    quantize,
    quantized_apply,
)
from cerberusnet_torch.quant.ptq import (
    flat_outputs,
    int8_conv2d,
    quantized_convs,
    rel_l2,
)
from cerberusnet_torch.testing import one_torch_thread  # noqa: F401
from cerberusnet_torch.train.config import ExperimentConfig
from cerberusnet_torch.train.trainer import Trainer
from cerberusnet_torch.weights import flax_conv_paths, load_flax_params

TINY = dict(encoder_channels=(8, 12, 16, 16, 16, 16), est_channels=(16, 16, 12),
            ctx_channels=(16, 16), fpn_channels=16)
HW = (64, 64)
HEADS = ("seg_logits", "flow", "disp")
# the port's parts and their trees in the reference's
PARTS = {"encoder": "PyramidEncoder_0", "disparity": "DisparityDecoder_0",
         "flow": "FlowDecoder_0", "segmentation": "SegmentationHead_0"}
HEAD_RTOL = 1e-4


def frames(seed, n=1):
    rng = np.random.RandomState(seed)
    return tuple(rng.rand(n, *HW, 3).astype(np.float32) for _ in range(3))


@pytest.fixture(scope="module")
def jax_side():
    """The JAX tiny model (unfused, pure correlations, as Trainer.export
    rebuilds it), its weights, two calibration batches, its scales, its
    quantized variables and quantized_apply's heads (int8) on a batch."""
    model = JaxCerberusNet(**TINY, corr_impl="pure", fused=False)
    calib = [frames(0), frames(1)]
    variables = jax.jit(model.init)(jax.random.PRNGKey(0), *calib[0])
    scales = jax_calibrate(model, variables, calib)
    qv = jax_quantize(variables, scales)
    batch = frames(2)
    out = jax.jit(lambda v, *x: jax_quantized_apply(model, v, *x))(qv, *batch)
    return {"params": jax.tree.map(np.asarray, variables["params"]),
            "calib": calib, "scales": scales, "batch": batch,
            "quant": jax.tree.map(np.asarray, qv[QUANT_COLLECTION]),
            "out": {k: np.asarray(out[k]) for k in HEADS}}


def port_model(params):
    """The port's tiny model in the JAX side's form: naive estimators
    (``fused=False``), whose convs the interception sees."""
    return load_flax_params(CerberusNet(**TINY, fused=False), params).eval()


def as_torch(batch):
    return tuple(torch.from_numpy(x) for x in batch)


@pytest.fixture(scope="module")
def port_side(jax_side):
    model = port_model(jax_side["params"])
    scales = calibrate(model, [as_torch(b) for b in jax_side["calib"]])
    return model, scales, flax_conv_paths(model)


@pytest.mark.parametrize("part", PARTS)
def test_calibration_scales_equal_jax(part, jax_side, port_side):
    """Conv by conv through the name map: the same set of convs, each
    absmax within 1e-5 relative."""
    _, scales, paths = port_side
    got = {paths[n]: v for n, v in scales.items() if n.startswith(part)}
    want = {k: v for k, v in jax_side["scales"].items()
            if k[0] == PARTS[part]}
    assert got and sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k] == pytest.approx(v, rel=1e-5), k


@pytest.mark.parametrize("part", PARTS)
def test_int8_kernels_and_scales_equal_jax(part, jax_side):
    """quantize with JAX's scales: int8 kernels equal (OIHW against
    HWIO), scale_w and in_scale within one float32 ulp."""
    model = port_model(jax_side["params"])
    paths = flax_conv_paths(model)
    quantize(model, {n: jax_side["scales"][p] for n, p in paths.items()
                     if p in jax_side["scales"]})
    checked = 0
    for name in quantized_convs(model):
        if not name.startswith(part):
            continue
        conv = model.get_submodule(name)
        q = jax_side["quant"]
        for key in paths[name]:
            q = q[key]
        np.testing.assert_array_equal(
            conv.kernel_q.numpy(), q["kernel_q"].transpose(3, 2, 0, 1),
            err_msg=name)
        np.testing.assert_allclose(conv.scale_w.numpy(), q["scale_w"],
                                   rtol=2.0**-23, atol=0, err_msg=name)
        np.testing.assert_allclose(conv.in_scale.numpy(), q["in_scale"],
                                   rtol=2.0**-23, atol=0, err_msg=name)
        checked += 1
    assert checked


# (C, O, kernel, stride, dilation, H, W): the stem (27 taps), a strided
# level entry, a dilated context block, a 1x1 lateral, the flow and
# disparity predictors (2 and 1 outputs) and the 19-class classifier
CONVS = {"stem": (3, 8, 3, 2, 1, 16, 24),
         "strided": (12, 16, 3, 2, 1, 8, 8),
         "dilated": (16, 16, 3, 1, 4, 12, 10),
         "lateral": (16, 16, 1, 1, 1, 5, 7),
         "flow_pred": (44, 2, 3, 1, 1, 6, 9),
         "disp_pred": (37, 1, 3, 1, 1, 4, 4),
         "classifier": (16, 19, 3, 1, 1, 9, 5)}


@pytest.mark.parametrize("kind", CONVS)
def test_one_conv_int32_sums_equal_jax(kind):
    """int8_conv2d (im2col and torch._int_mm, the reduction and outputs
    padded to multiples of 8, fewer than 17 rows padded) against XLA's
    int8 convolution with an int32 result, "SAME" as the port pads it: a
    stride-2 conv pads (0, 1) before it (models/common.py), the others
    symmetrically inside."""
    c, o, k, stride, dil, h, w = CONVS[kind]
    rng = np.random.RandomState(len(kind))
    x = rng.randint(-127, 128, (2, h, w, c)).astype(np.int8)
    kern = rng.randint(-127, 128, (k, k, c, o)).astype(np.int8)
    want = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(kern), (stride, stride), "SAME",
        rhs_dilation=(dil, dil), dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    if stride == 2:
        xt = torch.nn.functional.pad(xt, (0, 1, 0, 1))
    pad = 0 if stride == 2 else dil * (k - 1) // 2
    got = int8_conv2d(xt, torch.from_numpy(kern).permute(3, 2, 0, 1),
                      (stride, stride), (pad, pad), (dil, dil))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(),
                                  np.asarray(want))


@pytest.fixture(scope="module")
def quantized(jax_side):
    """The port model quantized with JAX's scales (so the comparison holds
    the quantized graph alone), and its int8 and simulated heads."""
    model = port_model(jax_side["params"])
    paths = flax_conv_paths(model)
    quantize(model, {n: jax_side["scales"][p] for n, p in paths.items()
                     if p in jax_side["scales"]})
    batch = as_torch(jax_side["batch"])
    with torch.no_grad():
        out = quantized_apply(model, *batch)
        sim = quantized_apply(model, *batch, simulate=True)
    return model, out, sim


@pytest.mark.parametrize("head", HEADS)
def test_quantized_apply_matches_jax(head, jax_side, quantized):
    _, out, _ = quantized
    got = out[head].numpy()
    want = jax_side["out"][head]
    assert got.shape == want.shape and got.dtype == want.dtype
    assert rel_l2(torch.from_numpy(got), torch.from_numpy(want)) <= HEAD_RTOL


@pytest.mark.parametrize("head", HEADS)
def test_simulate_matches_int8(head, quantized):
    """The plain version (a float32 convolution of the quantized values):
    the sums are integers below 2^24 at these widths, so only the order of
    float32 rounding in the convolution can differ; 1e-5 relative L2."""
    _, out, sim = quantized
    assert rel_l2(out[head], sim[head]) <= 1e-5


def test_int8_close_to_float(jax_side, quantized):
    """The reference's own limits on the joint model (tests/test_quant.py):
    seg 0.2, flow 0.35, disp 0.35 relative L2 against float32."""
    model = port_model(jax_side["params"])
    qmodel, _, _ = quantized
    errs = quantization_error(model, qmodel, as_torch(jax_side["batch"]))
    assert errs["seg_logits"] < 0.2
    assert errs["flow"] < 0.35
    assert errs["disp"] < 0.35


def test_skip_and_strip(jax_side, port_side):
    _, scales, _ = port_side
    model = port_model(jax_side["params"])
    with torch.no_grad():
        before = quantized_apply(
            quantize(port_model(jax_side["params"]), scales,
                     skip=("segmentation",)), *as_torch(jax_side["batch"]))
    quantize(model, scales, skip=("segmentation",), strip=True)
    names = quantized_convs(model)
    assert names and not any(n.startswith("segmentation") for n in names)
    for name in names:
        assert model.get_submodule(name).weight.shape == (0,)
    assert model.segmentation.classifier.weight.shape == (19, 16, 3, 3)
    with torch.no_grad():
        after = quantized_apply(model, *as_torch(jax_side["batch"]))
    for k in HEADS:
        torch.testing.assert_close(after[k], before[k], rtol=0, atol=0)
    with pytest.raises(ValueError, match="no convs quantized"):
        quantize(port_model(jax_side["params"]), scales, skip=("",))


def tiny_config(pallas_levels):
    return ExperimentConfig.from_dict({
        "name": "tiny-quant",
        "model": {"variant": "cerberus", "pallas_levels": pallas_levels,
                  **{k: list(v) if isinstance(v, tuple) else v
                     for k, v in TINY.items()}},
        "data": {"dataset": "synthetic", "hw": list(HW), "batch_size": 1,
                 "num_workers": 1, "synthetic_length": 2},
        "optim": {"schedule": "constant"},
        "train": {"num_data_devices": 1}})


@pytest.mark.parametrize("pallas_levels", [0, 3])
def test_quantized_set_equals_jax_after_rebuild(pallas_levels, jax_side):
    """Trainer.deploy_model(quant="int8") rebuilds the fused levels as
    plain ones, as the reference's export does: the convs it quantizes
    are the JAX set after the rebuild (every nn.Conv of the unfused
    model), the classifier among them."""
    tr = Trainer(tiny_config(pallas_levels), device="cpu")
    model = tr.deploy_model(quant="int8")
    assert model.encoder.fused_levels == 0
    paths = flax_conv_paths(model)
    got = {paths[n] for n in quantized_convs(model)}
    assert got == {k[:-1] for k in _flatten(jax_side["quant"])
                   if k[-1] == "kernel_q"}
    assert ("SegmentationHead_0", "Conv_5") in got
    with torch.no_grad():
        out = flat_outputs(quantized_apply(model, *as_torch(frames(3))))
    assert all(torch.isfinite(v).all() for v in out.values())

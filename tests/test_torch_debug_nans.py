"""``train.debug_nans`` (cerberusnet_torch/train/debug_nans.py and the
Trainer) against the reference's ``jax_debug_nans`` on the CPU: both raise
FloatingPointError on the same NaN batch, neither raises on an inf, and on a
clean batch the mode changes nothing. The JAX cases reset the global flag
they set."""

import jax
import numpy as np
import pytest
import torch

from cerberusnet_tpu.models import CerberusNet as JaxCerberusNet
from cerberusnet_torch.models.cerberus import CerberusNet
from cerberusnet_torch.testing import one_torch_thread  # noqa: F401
from cerberusnet_torch.train.config import ExperimentConfig
from cerberusnet_torch.train.debug_nans import DebugNans
from cerberusnet_torch.train.trainer import Trainer
from cerberusnet_torch.weights import load_flax_params

TINY = dict(encoder_channels=(8, 12, 16, 16, 16, 16), est_channels=(16, 16, 12),
            ctx_channels=(16, 16), fpn_channels=16)
HW = (64, 64)


def config(debug_nans):
    return ExperimentConfig.from_dict({
        "name": "tiny-nans",
        "model": {"variant": "cerberus", **{
            k: list(v) if isinstance(v, tuple) else v
            for k, v in TINY.items()}},
        "data": {"dataset": "synthetic", "hw": list(HW), "batch_size": 2,
                 "num_workers": 1, "synthetic_length": 2, "shuffle": False},
        "optim": {"lr": 1e-3, "schedule": "constant"},
        "train": {"num_data_devices": 1, "debug_nans": debug_nans}})


def with_jax_debug_nans(fn):
    """fn() with jax_debug_nans on, the flag reset after it."""
    jax.config.update("jax_debug_nans", True)
    try:
        return fn()
    finally:
        jax.config.update("jax_debug_nans", False)


def frames(bad=None):
    rng = np.random.RandomState(0)
    x = [rng.rand(1, *HW, 3).astype(np.float32) for _ in range(3)]
    if bad is not None:
        x[0][0, 5, 7, 1] = bad
    return x


@pytest.fixture(scope="module")
def models():
    jmodel = JaxCerberusNet(**TINY, corr_impl="pure")
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(0), *frames())
    model = load_flax_params(CerberusNet(**TINY),
                             jax.tree.map(np.asarray, variables["params"]))
    return jmodel, variables, model


def test_nan_frame_raises_in_both(models):
    """One NaN pixel: the reference's forward raises under jax_debug_nans,
    and the port's under DebugNans, naming the operator."""
    jmodel, variables, model = models
    x = frames(np.nan)
    with pytest.raises(FloatingPointError):
        with_jax_debug_nans(lambda: jax.block_until_ready(
            jax.jit(jmodel.apply)(variables, *x)))
    with pytest.raises(FloatingPointError,
                       match=r"nan\) encountered in aten\."):
        with torch.no_grad(), DebugNans():
            model(*(torch.from_numpy(v) for v in x))


@pytest.mark.parametrize("case", ["divide", "stem"])
def test_inf_does_not_raise_in_either(case, models):
    """An inf is not a NaN: 1/0, and the stem block on a frame with one inf
    pixel (each output sums one inf term, so it holds infs and no NaN), run
    in both without an error."""
    jmodel, variables, model = models
    if case == "divide":
        x = np.asarray([1.0, -2.0, 0.5], np.float32)
        want = with_jax_debug_nans(lambda: np.asarray(
            jax.jit(lambda v: v / 0.0)(x)))
        with DebugNans():
            got = torch.from_numpy(x) / 0.0
    else:
        x = frames(np.inf)[0]
        conv = variables["params"]["PyramidEncoder_0"]["ConvBlock_0"]
        want = with_jax_debug_nans(lambda: np.asarray(jax.jit(
            lambda v: jax.lax.conv_general_dilated(
                v, conv["Conv_0"]["kernel"], (2, 2), "SAME",
                dimension_numbers=("NHWC", "HWIO", "NHWC")))(x)))
        with torch.no_grad(), DebugNans():
            got = model.encoder.blocks[0](
                torch.from_numpy(x).permute(0, 3, 1, 2))
    assert np.isinf(want).any() and not np.isnan(want).any()
    assert torch.isinf(got).any() and not torch.isnan(got).any()


def test_mode_names_the_operator():
    with pytest.raises(FloatingPointError, match=r"aten\.div\.Tensor"):
        with DebugNans():
            torch.zeros(2) / torch.zeros(2)


def test_trainer_step_raises_on_a_nan_batch_and_recovers():
    """Trainer(train.debug_nans): a batch with one NaN pixel raises at an
    operator and changes no weight; the next, clean step runs."""
    tr = Trainer(config(True), device="cpu")
    batch = next(iter(tr._loader(tr.dataset, 2)))
    bad = dict(batch, left=batch["left"].astype(np.float32))
    bad["left"][0, 5, 7, 1] = np.nan
    before = {n: m.clone() for n, m in tr.masters.items()}
    with pytest.raises(FloatingPointError, match="encountered in"):
        tr.train_step(bad)
    for n, m in tr.masters.items():
        torch.testing.assert_close(m, before[n], rtol=0, atol=0)
    assert np.isfinite(float(tr.train_step(batch)["total"]))


def test_mode_leaves_a_clean_step_unchanged():
    """The same clean step with and without train.debug_nans: the same
    loss components, gradients and updated masters, bit for bit."""
    results = []
    for debug in (False, True):
        tr = Trainer(config(debug), device="cpu")
        batch = next(iter(tr._loader(tr.dataset, 2)))
        comps, grads = tr.loss_and_grads(batch)
        tr.apply_grads(grads)
        results.append((comps, grads, tr.masters))
    (c0, g0, m0), (c1, g1, m1) = results
    for a, b in ((c0, c1), (g0, g1), (m0, m1)):
        assert sorted(a) == sorted(b)
        for k in a:
            torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
    assert np.isfinite(list(tr.evaluate().values())).all()

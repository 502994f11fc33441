"""The port's fused encoder level (cerberusnet_torch.ops.encoder_level) and
the encoder and model that run it, against the JAX package.

The same numpy inputs go through the JAX functions (the Pallas kernels in
interpret mode on the CPU, their default off the TPU, and the plain XLA
level) and through the port, whose CPU tensors take the plain versions.
Tolerances: float32 differs only by summation order, 2e-5 for a level's
output and 2e-4 for its gradients (the tolerances of
tests/test_pallas_encoder.py); a model's outputs within 2e-4 of JAX's.
bfloat16: the port's distance to JAX's float32 level must stay within
twice JAX's own bfloat16 distance on the same inputs (each rounds at its
own places).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cerberusnet_tpu.models import CerberusNet as JaxCerberusNet
from cerberusnet_tpu.models.encoder import PyramidEncoder as JaxEncoder
from cerberusnet_tpu.ops.pallas.encoder_level import (
    _level_pallas_bwd,
)
from cerberusnet_tpu.ops.pallas.encoder_level import (
    encoder_level as jax_encoder_level,
)
from cerberusnet_tpu.ops.pallas.encoder_level import (
    encoder_level_xla,
)
from cerberusnet_torch.entry import entry
from cerberusnet_torch.models.cerberus import CerberusNet
from cerberusnet_torch.models.encoder import PyramidEncoder
from cerberusnet_torch.ops.cuda import encoder_level as cuda_level
from cerberusnet_torch.ops import library
from cerberusnet_torch.ops.encoder_level import (
    encoder_level,
    encoder_level_bwd_plain,
    encoder_level_plain,
)
from cerberusnet_torch.train.config import ExperimentConfig
from cerberusnet_torch.testing import one_torch_thread  # noqa: F401
from cerberusnet_torch.weights import load_flax_params



TINY = dict(
    encoder_channels=(8, 12, 16, 16, 16, 16),
    est_channels=(16, 16, 12),
    ctx_channels=(16, 16),
    fpn_channels=16,
)
GRAD_NAMES = ("dx", "dk1", "db1", "dk2", "db2", "dk3", "db3")


def level_inputs(b, h, w, c, f, seed=0):
    """x (B,H,W,C) and (k1, b1, k2, b2, k3, b3) as float32 numpy arrays,
    kernels ~ N(0, 0.04) and biases ~ N(0, 0.01) as in
    tests/test_pallas_encoder.py."""
    rng = np.random.RandomState(seed)
    x = rng.randn(b, h, w, c).astype(np.float32)
    kb = []
    for cin in (c, f, f):
        kb.append((0.2 * rng.randn(3, 3, cin, f)).astype(np.float32))
        kb.append((0.1 * rng.randn(f)).astype(np.float32))
    return x, kb


def t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12)


FWD_SHAPES = [
    (1, 8, 16, 3, 8),    # single tile
    (1, 16, 32, 3, 8),   # single tile, wider
    (2, 64, 32, 3, 8),   # multi-tile, batch 2
    (1, 128, 32, 8, 8),  # multi-tile
    (1, 72, 16, 3, 8),   # 9 tiles of 4 rows: the border cases
]


@pytest.mark.parametrize("shape", FWD_SHAPES, ids=str)
def test_plain_level_matches_jax(shape):
    x, kb = level_inputs(*shape)
    got = encoder_level_plain(t(x), *map(t, kb)).numpy()
    assert got.shape == (shape[0], shape[1] // 2, shape[2] // 2, shape[4])
    for want in (encoder_level_xla(x, *kb),
                 jax.jit(jax_encoder_level)(x, *kb)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=2e-5,
                                   atol=2e-5)


def test_plain_level_bf16_within_twice_jax_gap():
    x, kb = level_inputs(1, 32, 32, 3, 8, seed=1)
    xb = np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    kbb = [np.asarray(jnp.asarray(v, jnp.bfloat16).astype(jnp.float32))
           for v in kb]
    ref = np.asarray(encoder_level_xla(xb, *kbb))  # float32 on bf16 values
    jbf = jax.jit(jax_encoder_level)(jnp.asarray(xb, jnp.bfloat16),
                                     *[jnp.asarray(v, jnp.bfloat16)
                                       for v in kbb])
    got = encoder_level_plain(t(xb, torch.bfloat16),
                              *[t(v, torch.bfloat16) for v in kbb])
    assert got.dtype == torch.bfloat16
    jax_gap = rel_l2(np.asarray(jbf.astype(jnp.float32)), ref)
    port_gap = rel_l2(got.float().numpy(), ref)
    assert 0 < jax_gap < 0.05
    assert port_gap <= 2 * jax_gap, (port_gap, jax_gap)


@pytest.mark.parametrize("shape", [(1, 8, 16, 3, 8), (1, 64, 32, 3, 8),
                                   (2, 128, 32, 8, 8)], ids=str)
def test_plain_backward_matches_pallas_reverse_sweep(shape):
    x, kb = level_inputs(*shape, seed=5)
    y3 = np.asarray(encoder_level_xla(x, *kb))
    g = np.cos(np.arange(y3.size)).reshape(y3.shape).astype(np.float32)
    want = jax.jit(_level_pallas_bwd)(x, y3, g, *kb)
    got = encoder_level_bwd_plain(t(x), t(y3), t(g), *map(t, kb))
    for name, a, b in zip(GRAD_NAMES, got, want):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-4,
                                   atol=2e-4, err_msg=name)


@pytest.fixture
def level_on_cpu(monkeypatch):
    """The CUDA wrappers, counters included, with each launch replaced by
    its kernel's plain version, so the level's operator runs on CPU
    tensors. A
    launch checks the layouts the kernels need: NHWC-contiguous
    activations, HWIO-contiguous kernels, one type."""
    seen = []

    def check(x, kernels, acts=()):
        for v in (x, *kernels, *acts):
            assert v.is_contiguous() and v.dtype == x.dtype
        f = kernels[0].shape[-1]
        assert [tuple(v.shape) for v in kernels[::2]] == [
            (3, 3, x.shape[-1], f), (3, 3, f, f), (3, 3, f, f)]

    def fwd(x, kernels):
        check(x, kernels)
        return encoder_level_plain(x, *kernels)

    def bwd(x, y3, g, kernels, need_dx):
        check(x, kernels, (y3, g))
        seen.append(need_dx)
        dx, *rest = encoder_level_bwd_plain(x, y3, g, *kernels)
        return (dx if need_dx else None, *(d.float() for d in rest))

    monkeypatch.setattr(cuda_level, "_fwd", fwd)
    monkeypatch.setattr(cuda_level, "_bwd", bwd)
    cuda_level.reset_launches()
    yield seen
    cuda_level.reset_launches()


def weighted_loss(y):
    return (y * torch.cos(torch.arange(y.numel(), dtype=y.dtype)
                          ).reshape(y.shape)).sum()


@pytest.mark.parametrize("grad", ["pallas", "xla"])
def test_function_gradients_match_jax(grad, level_on_cpu):
    x, kb = level_inputs(1, 64, 32, 3, 8, seed=7)

    def jloss(x, *kb):
        y = jax_encoder_level(x, *kb, grad=grad)
        return (y * jnp.cos(jnp.arange(y.size)).reshape(y.shape)).sum()

    want = jax.jit(jax.grad(jloss, argnums=tuple(range(7))))(x, *kb)
    inputs = [t(v).requires_grad_() for v in (x, *kb)]
    out = library.encoder_level_fwd(*inputs, grad)
    np.testing.assert_allclose(out.detach().numpy(),
                               np.asarray(encoder_level_xla(x, *kb)),
                               rtol=2e-5, atol=2e-5)
    got = torch.autograd.grad(weighted_loss(out), inputs)
    for name, a, b in zip(GRAD_NAMES, got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-4,
                                   atol=2e-4, err_msg=name)
    counts = cuda_level.launches()
    assert counts == {"encoder_level_fwd": 1,
                      "encoder_level_bwd": 1 if grad == "pallas" else 0}


def test_function_skips_dx_nobody_needs(level_on_cpu):
    x, kb = level_inputs(2, 16, 16, 3, 8, seed=8)
    kernels = [t(v).requires_grad_() for v in kb]
    out = library.encoder_level_fwd(t(x), *kernels, "pallas")
    weighted_loss(out).backward()
    assert level_on_cpu == [False]
    assert all(k.grad is not None for k in kernels)


def test_function_takes_layouts_as_the_model_hands_them(level_on_cpu):
    """The encoder hands the operator an NHWC view of a channels_last bf16
    activation and HWIO views of OIHW conv weights; the gradients come
    back in the weights' layout and type."""
    torch.manual_seed(0)
    convs = [torch.nn.Conv2d(cin, 8, 3).to(torch.bfloat16,
                                           memory_format=torch.channels_last)
             for cin in (3, 8, 8)]
    x = torch.randn(2, 3, 16, 32).to(torch.bfloat16,
                                     memory_format=torch.channels_last)
    params = [v for c in convs for v in (c.weight.permute(2, 3, 1, 0),
                                         c.bias)]
    xv = x.permute(0, 2, 3, 1)
    out = library.encoder_level_fwd(xv, *params, "pallas")
    torch.testing.assert_close(out, encoder_level_plain(xv, *params))
    weighted_loss(out.float()).backward()
    for c in convs:
        for p in (c.weight, c.bias):
            assert p.grad is not None and p.grad.dtype == torch.bfloat16
            assert p.grad.shape == p.shape


@pytest.mark.parametrize("shape", [(1, 9, 16, 3, 8), (1, 16, 18, 3, 8)],
                         ids=str)
def test_odd_extents_raise(shape):
    x, kb = level_inputs(*shape)
    with pytest.raises(ValueError, match="H%2"):
        encoder_level(t(x), *map(t, kb))


def test_knobs_that_exclude_each_other_raise():
    for knob in ({"s2d_levels": 1}, {"s2d_stem": True},
                 {"stem_pad_channels": 4}):
        cfg = ExperimentConfig.from_dict(
            {"model": {"pallas_levels": 1, **knob}})
        with pytest.raises(ValueError, match="mutually exclusive"):
            cfg.check_supported()
        # no effect without pallas_levels, nor on a DCV variant
        ExperimentConfig.from_dict({"model": knob}).check_supported()
        ExperimentConfig.from_dict({"model": {
            "variant": "cerberus_dcv", "pallas_levels": 1, **knob}}
        ).check_supported()
    x, kb = level_inputs(1, 8, 8, 3, 4)
    with pytest.raises(ValueError, match="unknown grad"):
        encoder_level(t(x), *map(t, kb), grad="mosaic")


def test_entry_refuses_fused_levels_where_there_are_none():
    with pytest.raises(ValueError, match="no fused encoder levels"):
        entry(device="cpu", variant="cerberus_dcv", pallas_levels=3)


# --------------------------------------------------- encoder and model


def random_params(shapes, seed):
    """A param tree of ``shapes`` (from jax.eval_shape of an init)."""
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        if path[-1].key == "kernel":
            fan_in = int(np.prod(leaf.shape[:-1]))
            return (rng.randn(*leaf.shape) / np.sqrt(fan_in)).astype(
                np.float32)
        return (0.1 * rng.randn(*leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def test_pyramid_encoder_three_fused_levels_matches_jax():
    chans = TINY["encoder_channels"]
    x = np.random.RandomState(3).randn(2, 64, 64, 3).astype(np.float32)
    jenc = JaxEncoder(chans, pallas_levels=3)
    params = random_params(jax.eval_shape(
        jenc.init, jax.random.PRNGKey(0), jnp.asarray(x))["params"], 4)
    want = jax.jit(jenc.apply)({"params": params}, x)
    enc = load_flax_params(PyramidEncoder(chans, pallas_levels=3), params)
    assert enc.state_dict().keys() == PyramidEncoder(chans).state_dict().keys()
    with torch.no_grad():
        got = enc(t(x).permute(0, 3, 1, 2))
    assert len(got) == len(want) == 6
    for level, (a, b) in enumerate(zip(got, want), 1):
        np.testing.assert_allclose(a.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(b), rtol=2e-5, atol=2e-5,
                                   err_msg=f"level {level}")


OUT_KEYS = ("flow", "disp", "seg_logits")


@pytest.fixture(scope="module")
def jax_cerberus():
    """JAX CerberusNet(pallas_levels=2) at 64x64 (the case of
    tests/test_pallas_encoder.py): params, frames, outputs, and the
    gradients of a fixed weighted sum of the three heads. One trace gives
    the parameter and output shapes, and one compiled call the outputs
    and gradients: the forward is traced and compiled once."""
    rng = np.random.RandomState(9)
    imgs = [rng.randn(1, 64, 64, 3).astype(np.float32) for _ in range(3)]
    model = JaxCerberusNet(pallas_levels=2, pallas_grad="pallas", **TINY)
    out_shapes, shapes = jax.eval_shape(model.init_with_output,
                                        jax.random.PRNGKey(0), *imgs)
    params = random_params(shapes["params"], 10)
    weights = {k: rng.randn(*out_shapes[k].shape).astype(np.float32)
               for k in OUT_KEYS}

    def loss(p):
        o = model.apply({"params": p}, *imgs)
        return sum((o[k] * weights[k]).sum() for k in OUT_KEYS), o

    (_, out), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    to_np = lambda tree: jax.tree.map(np.asarray, tree)  # noqa: E731
    return (to_np(params), imgs, {k: np.asarray(out[k]) for k in OUT_KEYS},
            weights, to_np(grads))


def test_cerberus_two_fused_levels_matches_jax(jax_cerberus):
    params, imgs, want, weights, jgrads = jax_cerberus
    model = load_flax_params(
        CerberusNet(pallas_levels=2, pallas_grad="pallas", **TINY), params)
    out = model(*[t(i) for i in imgs])
    for k in OUT_KEYS:
        np.testing.assert_allclose(out[k].detach().numpy(), want[k],
                                   rtol=2e-4, atol=2e-4, err_msg=k)
    loss = sum((out[k] * t(weights[k])).sum() for k in OUT_KEYS)
    loss.backward()
    want_g = load_flax_params(CerberusNet(**TINY), jgrads)
    for (name, p), (_, g) in zip(model.named_parameters(),
                                 want_g.named_parameters()):
        assert rel_l2(p.grad.numpy(), g.detach().numpy()) <= 2e-4, name

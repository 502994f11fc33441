"""The port's model (cerberusnet_torch) against the JAX CerberusNet.

Random flax parameters (shapes from ``jax.eval_shape`` of the reference's
init, values from numpy, biases non-zero) are loaded into the port with
``load_flax_params``; the same numpy frames go through both. Each part of
the port is fed the reference's own inputs to that part, taken from the
reference's intermediates, so a fault shows in the part that has it.

Tolerances: in float32 the two differ only by summation order, so
max|port - JAX| / max(max|JAX|, 1) <= 1e-4 for every output. In bfloat16
the port's error against JAX float32 must be at most twice JAX's own
bfloat16 error against its float32 on the same weights and inputs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cerberusnet_tpu.models import CerberusNet as JaxCerberusNet
from cerberusnet_torch.models.cerberus import CerberusNet
from cerberusnet_torch.models.disparity import DisparityDecoder
from cerberusnet_torch.models.encoder import PyramidEncoder
from cerberusnet_torch.models.flow import FlowDecoder
from cerberusnet_torch.models.segmentation import SegmentationHead
from cerberusnet_torch.testing import one_torch_thread  # noqa: F401
from cerberusnet_torch.weights import init_params, load_flax_params



TINY = dict(
    encoder_channels=(8, 12, 16, 16, 16, 16),
    est_channels=(16, 16, 12),
    ctx_channels=(16, 16),
    fpn_channels=16,
)
PARTS = ("PyramidEncoder", "FlowDecoder", "DisparityDecoder",
         "SegmentationHead")
OUTPUTS = ("seg_logits", "flow", "disp", "flow_pyramid", "disp_pyramid")


def frames(hw, seed):
    rng = np.random.RandomState(seed)
    return [rng.rand(1, *hw, 3).astype(np.float32) for _ in range(3)]


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


def jax_apply(model, params, imgs, capture=False):
    def run(p, *x):
        if not capture:
            return model.apply({"params": p}, *x)
        return model.apply(
            {"params": p}, *x, mutable=["intermediates"],
            capture_intermediates=lambda mdl, method: (
                method == "__call__" and type(mdl).__name__ in PARTS))

    return jax.jit(run)(params, *[jnp.asarray(i) for i in imgs])


def to_np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def nchw(a):
    """numpy NHWC -> torch NCHW (channels_last)."""
    return torch.from_numpy(np.array(a, np.float32)).permute(0, 3, 1, 2)


def nhwc(t):
    return t.permute(0, 2, 3, 1)


def flat(out):
    """Output dict -> {name: numpy array}, pyramids split by level."""
    res = {}
    for key, v in out.items():
        if isinstance(v, dict):
            for level, t in v.items():
                res[f"{key}[{level}]"] = to_np(t)
        else:
            res[key] = to_np(v)
    return res


def assert_f32_close(got, want, what=""):
    got, want = to_np(got), to_np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1.0)
    assert err <= 1e-4, f"{what}: relative max error {err}"


def port_model(params, **kw):
    model = CerberusNet(num_classes=7, **TINY, **kw).eval()
    return load_flax_params(model, params)


@pytest.fixture(scope="module")
def tiny():
    imgs = frames((64, 64), 0)
    jmodel = JaxCerberusNet(corr_impl="pure", num_classes=7, **TINY)
    params = random_params(jmodel, imgs, 1)
    out, state = jax_apply(jmodel, params, imgs, capture=True)
    inter = {k.rsplit("_", 1)[0]: v["__call__"][0]
             for k, v in state["intermediates"].items()}
    return imgs, params, out, inter


def run_port(model, imgs):
    with torch.no_grad():
        return model(*[torch.from_numpy(i) for i in imgs])


class TestParts:
    """Each part of the port, fed the reference's inputs to that part."""

    def test_pyramid_encoder(self, tiny):
        imgs, params, _, inter = tiny
        enc = load_flax_params(PyramidEncoder(TINY["encoder_channels"]),
                               params["PyramidEncoder_0"])
        with torch.no_grad():
            feats = enc(nchw(np.concatenate(imgs, 0)))
        assert len(feats) == len(inter["PyramidEncoder"]) == 6
        for level, (f, jf) in enumerate(zip(feats, inter["PyramidEncoder"]), 1):
            assert_f32_close(nhwc(f), jf, f"level {level}")

    @pytest.mark.parametrize("kind", ["FlowDecoder", "DisparityDecoder"])
    def test_decoder(self, tiny, kind):
        _, params, _, inter = tiny
        cls = FlowDecoder if kind == "FlowDecoder" else DisparityDecoder
        dec = load_flax_params(
            cls(TINY["encoder_channels"], est_channels=TINY["est_channels"],
                ctx_channels=TINY["ctx_channels"]),
            params[f"{kind}_0"])
        feats = inter["PyramidEncoder"]
        other = 2 if kind == "FlowDecoder" else 1  # temporal | right
        with torch.no_grad():
            out = dec([nchw(f[:1]) for f in feats],
                      [nchw(f[other : other + 1]) for f in feats])
        got = {k: ({l: nhwc(t) for l, t in v.items()} if isinstance(v, dict)
                   else nhwc(v)) for k, v in out.items()}
        want = flat(inter[kind])
        got = flat(got)
        assert sorted(got) == sorted(want)
        for key in want:
            assert_f32_close(got[key], want[key], key)

    def test_segmentation_head(self, tiny):
        _, params, _, inter = tiny
        seg = load_flax_params(
            SegmentationHead(TINY["encoder_channels"], 7, TINY["fpn_channels"]),
            params["SegmentationHead_0"])
        with torch.no_grad():
            logits = seg([nchw(f[:1]) for f in inter["PyramidEncoder"]],
                         (64, 64))
        assert logits.dtype == torch.float32
        assert_f32_close(nhwc(logits), inter["SegmentationHead"], "seg")


class TestCerberusNet:
    def test_matches_jax_pure(self, tiny):
        imgs, params, jout, _ = tiny
        got, want = flat(run_port(port_model(params), imgs)), flat(jout)
        assert sorted(got) == sorted(want)
        assert len(want) == 13  # 3 heads + 5 levels in each pyramid
        for key in want:
            assert_f32_close(got[key], want[key], key)

    def test_matches_jax_pallas_kernels(self, tiny):
        imgs, params, _, _ = tiny
        jmodel = JaxCerberusNet(corr_impl="pallas", num_classes=7, **TINY)
        want = flat(jax_apply(jmodel, params, imgs))
        got = flat(run_port(port_model(params), imgs))
        for key in want:
            assert_f32_close(got[key], want[key], key)

    def test_default_widths(self):
        imgs = frames((64, 128), 2)
        jmodel = JaxCerberusNet(corr_impl="pure")
        params = random_params(jmodel, imgs, 3)
        want = flat(jax_apply(jmodel, params, imgs))
        model = load_flax_params(CerberusNet().eval(), params)
        got = flat(run_port(model, imgs))
        assert got["seg_logits"].shape == (1, 64, 128, 19)
        for key in want:
            assert_f32_close(got[key], want[key], key)

    def test_bf16_within_twice_jax_gap(self, tiny):
        imgs, params, jf32, _ = tiny
        jmodel = JaxCerberusNet(corr_impl="pure", num_classes=7,
                                dtype=jnp.bfloat16, **TINY)
        jbf16 = flat(jax_apply(jmodel, params, imgs))
        out = run_port(port_model(params, dtype=torch.bfloat16), imgs)
        assert out["flow"].dtype == torch.float32
        assert out["flow_pyramid"][2].dtype == torch.bfloat16
        port, ref = flat(out), flat(jf32)

        def rel_l2(a, b):
            return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12)

        for key in ref:
            jax_gap = rel_l2(jbf16[key], ref[key])
            port_gap = rel_l2(port[key], ref[key])
            assert port_gap <= 2 * jax_gap, (
                f"{key}: port bf16 gap {port_gap} > 2 x JAX bf16 gap {jax_gap}")


class TestWeights:
    def test_missing_parameter_raises(self, tiny):
        _, params, _, _ = tiny
        pruned = dict(params)
        dec = dict(pruned["FlowDecoder_0"])
        del dec["ContextNetwork_0"]
        pruned["FlowDecoder_0"] = dec
        with pytest.raises(KeyError):
            port_model(pruned)

    def test_init_matches_flax_scale(self):
        model = init_params(CerberusNet(**TINY),
                            torch.Generator().manual_seed(0))
        conv = model.flow.estimators[4].blocks[0].conv
        fan_in = conv.weight[0].numel()
        w = conv.weight.detach()
        assert w.abs().max() <= 2 * (1 / fan_in) ** 0.5 / 0.8796 + 1e-6
        assert w.std().item() == pytest.approx((1 / fan_in) ** 0.5, rel=0.1)
        assert torch.all(conv.bias == 0)

    def test_init_is_seeded(self):
        a, b = (init_params(CerberusNet(**TINY),
                            torch.Generator().manual_seed(5))
                for _ in range(2))
        for pa, pb in zip(a.parameters(), b.parameters()):
            assert torch.equal(pa, pb)

    def test_bf16_model_keeps_classifier_f32(self):
        model = CerberusNet(**TINY, dtype=torch.bfloat16)
        assert model.dtype == torch.bfloat16
        assert model.segmentation.classifier.weight.dtype == torch.float32
        assert model.flow.predictors[0].weight.is_contiguous(
            memory_format=torch.channels_last)

"""The port's test-time augmentation and tiled inference
(cerberusnet_torch/eval/tta.py and tiled.py) and ``Trainer.evaluate_tta``,
against the JAX package on the CPU.

* With stub models: the cases of tests/test_tta.py (the identity, a flip
  negating u, disparity's mirrored pass skipped by default and swapping
  the stereo pair when asked, the per-key counts of a joint model, the
  values rescaled at a scale, the scales averaged; tiling exact for a
  pointwise model, a tile larger than the image, ``batch_tiles`` equal to
  the sequential blend with nested outputs).
* A tiny CerberusNet and CerberusRAFT, loaded from the same random flax
  parameters, through both packages' ``tta_forward`` (scales 0.5 and 1.0,
  flip) and ``tiled_forward`` (a 128x128 frame in 64x64 tiles, overlap
  0.5, sequential and batched): every output within 1e-4 of
  max(max|JAX|, 1) (test_torch_model.py's rule).
* CerberusNet at 64x128 and scale 0.75 (48x96) raises the same
  ValueError in both: the reference's warp refuses a side that is no
  multiple of 64.
* ``Trainer.evaluate_tta(per_class=True)`` of a tiny SegNet against the
  JAX Trainer's on the same weights: the same 24 keys, each within 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cerberusnet_torch.eval import tiled_forward, tta_forward
from cerberusnet_torch.models.cerberus import CerberusNet
from cerberusnet_torch.models.raft import CerberusRAFT
from cerberusnet_torch.testing import one_torch_thread  # noqa: F401
from cerberusnet_torch.train.config import ExperimentConfig
from cerberusnet_torch.train.trainer import Trainer
from cerberusnet_torch.weights import load_flax_params
from cerberusnet_tpu.eval import tiled_forward as jax_tiled_forward
from cerberusnet_tpu.eval import tta_forward as jax_tta_forward
from cerberusnet_tpu.models import CerberusNet as JaxCerberusNet
from cerberusnet_tpu.models import CerberusRAFT as JaxCerberusRAFT
from tests.jax_pairs import draw_params, numpy_tree, port_masters

KEYS = ("left", "right", "temporal")


def _batch(h=16, w=24):
    rng = np.random.RandomState(0)
    return {k: torch.from_numpy(rng.rand(1, h, w, 3).astype(np.float32))
            for k in KEYS}


def _np(x):
    return x.detach().float().numpy()


# ------------------------------------------------------ TTA, stub models


def test_identity_equals_forward():
    def forward(batch):
        x = batch["left"]
        return {"seg_logits": x, "flow": x[..., :2], "disp": x[..., :1]}

    b = _batch()
    out = tta_forward(forward, b, scales=(1.0,), flip=False)
    np.testing.assert_allclose(_np(out["seg_logits"]), _np(b["left"]),
                               rtol=1e-6)
    np.testing.assert_allclose(_np(out["flow"]), _np(b["left"][..., :2]),
                               rtol=1e-6)
    assert all(v.dtype == torch.float32 for v in out.values())


def test_flip_negates_u_for_constant_flow():
    def forward(batch):
        shape = batch["left"].shape[:3] + (2,)
        return {"flow": torch.tensor([3.0, 5.0]).expand(shape)}

    out = tta_forward(forward, _batch(), scales=(1.0,), flip=True)
    np.testing.assert_allclose(_np(out["flow"][..., 0]), 0.0, atol=1e-5)
    np.testing.assert_allclose(_np(out["flow"][..., 1]), 5.0, atol=1e-5)


def test_flip_skips_disp_by_default():
    seen = []

    def forward(batch):
        seen.append(batch)
        return {"disp": batch["left"][..., :1] * 0 + 2.0}

    out = tta_forward(forward, _batch(), scales=(1.0,), flip=True)
    assert len(seen) == 1
    np.testing.assert_allclose(_np(out["disp"]), 2.0, atol=1e-5)


def test_flip_swap_optin_swaps_stereo_pair():
    seen = []

    def forward(batch):
        seen.append(batch)
        return {"disp": batch["left"][..., :1] * 0 + 2.0}

    b = _batch()
    out = tta_forward(forward, b, scales=(1.0,), flip=True, disp_flip="swap")
    assert len(seen) == 2
    np.testing.assert_array_equal(_np(seen[1]["left"]),
                                  _np(b["right"].flip(2)))
    np.testing.assert_array_equal(_np(seen[1]["right"]),
                                  _np(b["left"].flip(2)))
    np.testing.assert_allclose(_np(out["disp"]), 2.0, atol=1e-5)
    with pytest.raises(ValueError, match="disp_flip"):
        tta_forward(forward, b, flip=True, disp_flip="mirror")


def test_joint_model_flip_anchors_per_task():
    seen = []

    def forward(batch):
        seen.append(batch)
        x = batch["left"]
        return {"seg_logits": x, "flow": x[..., :2],
                "disp": x[..., :1] * 0 + 4.0}

    b = _batch()
    out = tta_forward(forward, b, scales=(1.0,), flip=True)
    assert len(seen) == 2
    for k in KEYS:  # mirrored, not swapped
        np.testing.assert_array_equal(_np(seen[1][k]), _np(b[k].flip(2)))
    np.testing.assert_allclose(_np(out["seg_logits"]), _np(b["left"]),
                               rtol=1e-5)
    np.testing.assert_allclose(_np(out["disp"]), 4.0, atol=1e-5)


def test_joint_model_flip_swap_runs_three_passes():
    seen = []

    def forward(batch):
        seen.append(batch)
        x = batch["left"]
        return {"seg_logits": x * 0 + 1.0, "flow": x[..., :2] * 0,
                "disp": x[..., :1] * 0 + 3.0}

    b = _batch()
    out = tta_forward(forward, b, scales=(1.0,), flip=True, disp_flip="swap")
    assert len(seen) == 3
    np.testing.assert_array_equal(_np(seen[2]["left"]),
                                  _np(b["right"].flip(2)))
    np.testing.assert_allclose(_np(out["seg_logits"]), 1.0, atol=1e-5)
    np.testing.assert_allclose(_np(out["disp"]), 3.0, atol=1e-5)


@pytest.mark.parametrize("key,value,want", [
    ("flow", [4.0, 2.0], [8.0, 4.0]), ("disp", [6.0], [12.0])])
def test_scale_rescales_values(key, value, want):
    def forward(batch):
        shape = batch["left"].shape[:3] + (len(value),)
        return {key: torch.tensor(value).expand(shape)}

    out = tta_forward(forward, _batch(), scales=(0.5,), flip=False)
    np.testing.assert_allclose(_np(out[key]),
                               np.broadcast_to(want, out[key].shape),
                               rtol=1e-5)


def test_multi_scale_seg_averages():
    def forward(batch):
        h = batch["left"].shape[1]
        return {"seg_logits": torch.full((*batch["left"].shape[:3], 4),
                                         float(h))}

    out = tta_forward(forward, _batch(16, 24), scales=(1.0, 0.5))
    np.testing.assert_allclose(_np(out["seg_logits"]), 12.0, rtol=1e-5)


def test_stub_tta_equals_jax():
    """A pointwise stub at three scales with flip and the swapped
    disparity pass: the resizes (jax.image.resize's antialiased bilinear)
    and inverses agree with the reference's."""
    def port_fwd(b):
        x = b["left"] * 2.0 + b["right"]
        return {"seg_logits": x, "flow": x[..., :2] - 0.5,
                "disp": b["left"][..., 1:2] * 3.0}

    def jax_fwd(_, b):
        x = b["left"] * 2.0 + b["right"]
        return {"seg_logits": x, "flow": x[..., :2] - 0.5,
                "disp": b["left"][..., 1:2] * 3.0}

    b = _batch(20, 36)
    kw = dict(scales=(0.75, 1.0, 1.5), flip=True, disp_flip="swap")
    got = tta_forward(port_fwd, b, **kw)
    want = jax_tta_forward(jax_fwd, {}, {k: jnp.asarray(_np(v))
                                         for k, v in b.items()}, **kw)
    for k in want:
        np.testing.assert_allclose(_np(got[k]), np.asarray(want[k]),
                                   rtol=0, atol=1e-5, err_msg=k)


# ---------------------------------------------------- tiling, stub models


def _pointwise(batch):
    x = batch["left"]
    return {"seg_logits": x * 2.0 + 1.0, "flow": x[..., :2] - 0.5,
            "disp": x[..., :1] * 3.0,
            # real models nest their pyramids by level
            "flow_pyramid": {2: x[..., :2] * 0.25}}


def test_pointwise_model_tiling_is_exact():
    b = _batch(40, 56)
    ref = _pointwise(b)
    out = tiled_forward(_pointwise, b, tile_hw=(16, 24), overlap=0.25)
    assert sorted(out) == ["disp", "flow", "seg_logits"]
    for k in out:
        np.testing.assert_allclose(_np(out[k]), _np(ref[k]), rtol=1e-5,
                                   atol=1e-5)


def test_tile_larger_than_image():
    b = _batch(16, 24)
    out = tiled_forward(lambda bt: {"disp": bt["left"][..., :1]}, b,
                        tile_hw=(32, 32))
    np.testing.assert_allclose(_np(out["disp"]), _np(b["left"][..., :1]),
                               rtol=1e-5)


def test_batch_tiles_matches_sequential():
    b = _batch(40, 56)
    calls = []

    def forward(batch):
        calls.append(batch["left"].shape[0])
        return _pointwise(batch)

    seq = tiled_forward(forward, b, tile_hw=(16, 24), overlap=0.25)
    n = len(calls)
    bat = tiled_forward(forward, b, tile_hw=(16, 24), overlap=0.25,
                        batch_tiles=True)
    assert n == 9 and calls[n:] == [n]  # one forward of every tile
    for k in seq:
        np.testing.assert_allclose(_np(bat[k]), _np(seq[k]), rtol=1e-5,
                                   atol=1e-5)


def test_stub_tiling_equals_jax():
    b = _batch(40, 56)

    def jax_fwd(_, bt):
        x = bt["left"] * jnp.cos(bt["right"])
        return {"seg_logits": x * 2.0 + 1.0, "flow": x[..., :2] - 0.5,
                "disp": x[..., :1] * 3.0}

    def port_fwd(bt):
        x = bt["left"] * torch.cos(bt["right"])
        return {"seg_logits": x * 2.0 + 1.0, "flow": x[..., :2] - 0.5,
                "disp": x[..., :1] * 3.0}

    got = tiled_forward(port_fwd, b, tile_hw=(16, 24), overlap=0.3)
    want = jax_tiled_forward(jax_fwd, {}, {k: jnp.asarray(_np(v))
                                           for k, v in b.items()},
                             tile_hw=(16, 24), overlap=0.3)
    for k in want:
        np.testing.assert_allclose(_np(got[k]), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-6, err_msg=k)


# ------------------------------------------------- tiny models, both packages

ENC = (8, 12, 16, 16, 16, 16)
NETS = {
    "CerberusNet": (
        lambda: JaxCerberusNet(encoder_channels=ENC, est_channels=(16, 16, 12),
                               ctx_channels=(16, 16), fpn_channels=16,
                               num_classes=5, corr_impl="purev"),
        lambda: CerberusNet(encoder_channels=ENC, est_channels=(16, 16, 12),
                            ctx_channels=(16, 16), fpn_channels=16,
                            num_classes=5),
        128),
    "CerberusRAFT": (
        lambda: JaxCerberusRAFT(encoder_channels=ENC, num_classes=5, level=3,
                                fdim=16, hdim=12, cdim=8, corr_levels=2,
                                radius=2, iters=2, fpn_channels=16),
        lambda: CerberusRAFT(encoder_channels=ENC, num_classes=5, level=3,
                             fdim=16, hdim=12, cdim=8, corr_levels=2,
                             radius=2, iters=2, fpn_channels=16),
        64),
}


def frames(hw, seed=0):
    rng = np.random.RandomState(seed)
    return {k: rng.rand(1, *hw, 3).astype(np.float32) for k in KEYS}


@pytest.fixture(scope="module")
def pair():
    """Per model: (the jitted JAX forward with its variables, the port's
    forward on the same weights)."""
    cache = {}

    def get(name):
        if name not in cache:
            jax_model, port_model, _ = NETS[name]
            jm = jax_model()
            imgs = [jnp.asarray(v) for v in frames((64, 64)).values()]
            shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                                    *imgs)["params"]
            params = draw_params(shapes, 5)
            fwd = jax.jit(lambda v, b: jm.apply(v, *[b[k] for k in KEYS]))
            model = load_flax_params(port_model(), params).eval()

            def port_fwd(b):
                with torch.no_grad():
                    return model(*[b[k] for k in KEYS])

            cache[name] = (fwd, {"params": params}, port_fwd)
        return cache[name]

    return get


def assert_outputs_close(got, want):
    assert sorted(got) == sorted(want) == ["disp", "flow", "seg_logits"]
    for k in want:
        w = np.asarray(want[k])
        assert got[k].shape == w.shape, k
        err = np.abs(_np(got[k]) - w).max() / max(np.abs(w).max(), 1)
        assert err <= 1e-4, (k, err)


@pytest.mark.parametrize("name", list(NETS))
def test_model_tta_equals_jax(pair, name):
    fwd, variables, port_fwd = pair(name)
    hw = (NETS[name][2],) * 2
    b = frames(hw, 1)
    kw = dict(scales=(0.5, 1.0), flip=True)
    want = jax_tta_forward(fwd, variables, {k: jnp.asarray(v)
                                            for k, v in b.items()}, **kw)
    got = tta_forward(port_fwd, {k: torch.from_numpy(v)
                                 for k, v in b.items()}, **kw)
    assert_outputs_close(got, want)


@pytest.mark.parametrize("batch_tiles", [False, True])
@pytest.mark.parametrize("name", list(NETS))
def test_model_tiling_equals_jax(pair, name, batch_tiles):
    fwd, variables, port_fwd = pair(name)
    b = frames((128, 128), 2)
    kw = dict(tile_hw=(64, 64), overlap=0.5, batch_tiles=batch_tiles)
    want = jax_tiled_forward(fwd, variables, {k: jnp.asarray(v)
                                              for k, v in b.items()}, **kw)
    got = tiled_forward(port_fwd, {k: torch.from_numpy(v)
                                   for k, v in b.items()}, **kw)
    assert got["seg_logits"].shape == (1, 128, 128, 5)
    assert_outputs_close(got, want)


def test_cerberusnet_tta_scale_off_the_warp_grid_raises_in_both(pair):
    fwd, variables, port_fwd = pair("CerberusNet")
    b = frames((64, 128), 3)
    with pytest.raises(ValueError) as jax_error:
        jax_tta_forward(fwd, variables, {k: jnp.asarray(v)
                                         for k, v in b.items()},
                        scales=(0.75,))
    with pytest.raises(ValueError) as port_error:
        tta_forward(port_fwd, {k: torch.from_numpy(v) for k, v in b.items()},
                    scales=(0.75,))
    assert str(port_error.value) == str(jax_error.value)
    assert "!=" in str(port_error.value)


# --------------------------------------------------------- evaluate_tta


def test_evaluate_tta_per_class_equals_jax_trainer():
    from cerberusnet_tpu.train.trainer import Trainer as JaxTrainer
    from tests.test_train_step import tiny_config

    jt = JaxTrainer(tiny_config(variant="seg"))
    want = jt.evaluate_tta(scales=(1.0, 0.5), flip=True, per_class=True)
    cfg = ExperimentConfig.from_json(jt.config.to_json())
    tr = Trainer(cfg, device="cpu")
    tr.load_masters(port_masters(cfg, numpy_tree(jt.state.params)))
    got = tr.evaluate_tta(scales=(1.0, 0.5), flip=True, per_class=True)
    assert sorted(got) == sorted(want)
    assert len([k for k in got if k.startswith("iou/")]) == 19
    for k, v in want.items():
        if np.isnan(v):
            assert np.isnan(got[k]), k
        else:
            assert abs(got[k] - v) <= 1e-4, (k, got[k], v)

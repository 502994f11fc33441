"""The port's augmentation (cerberusnet_torch.data.augment) against the
JAX package's ``augment_batch``, on the CPU.

The port draws from a ``torch.Generator``, so its draws cannot equal
``jax.random``'s. Each test rebuilds the reference's draws from its key
with ``jax.random`` as ``augment_batch`` makes them (``split(key, 4)``;
the zoom index from ``fold_in(k_crop, 2)``, the offsets from ``k_crop``
and ``fold_in(k_crop, 1)`` with the chosen branch's bounds, ``bernoulli``
on ``k_flip``, ``uniform`` on ``fold_in(k_contrast, i)`` and
``fold_in(k_bright, i)`` for image key i), feeds them to the port's
``apply`` and compares: crops, flips, labels, flow, disparity and their
masks exactly; uint8 images exactly where nothing is resampled or
rescaled, and within one level (of 255) where the bilinear zoom or the
photometric jitter rounds a float, with at most 1% of the values moved
(the two packages sum the contrast's mean and the resize's taps in
different orders, which moves a value across a rounding edge now and
then).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cerberusnet_tpu.data.augment import AugmentConfig as JaxAugmentConfig
from cerberusnet_tpu.data.augment import augment_batch
from cerberusnet_torch.data import augment
from cerberusnet_torch.testing import one_torch_thread  # noqa: F401

B, H, W = 3, 40, 56
IMAGES = ("left", "right", "temporal")
CASES = {
    "crop": dict(crop_hw=(24, 32)),
    "scales": dict(crop_hw=(24, 32), scales=(0.8, 1.0, 1.25)),
    "flip": dict(flip_lr_prob=0.5),
    "photometric": dict(brightness=0.2, contrast=0.2),
    # configs/seg_aspp_cityscapes.json's set, at a small size
    "seg_aspp": dict(crop_hw=(24, 32), flip_lr_prob=0.5, brightness=0.2,
                     contrast=0.2),
}


def make_batch(stereo=False, seed=0):
    rng = np.random.RandomState(seed)
    batch = {k: rng.randint(0, 256, (B, H, W, 3)).astype(np.uint8)
             for k in IMAGES}
    batch["seg_labels"] = rng.randint(0, 19, (B, H, W)).astype(np.uint8)
    batch["flow_gt"] = (5 * rng.randn(B, H, W, 2)).astype(np.float32)
    batch["flow_valid"] = (rng.rand(B, H, W) < 0.7).astype(np.float32)
    if stereo:
        batch["disp_gt"] = (20 * rng.rand(B, H, W)).astype(np.float32)
        batch["disp_valid"] = (rng.rand(B, H, W) < 0.7).astype(np.float32)
    return batch


def jax_draws(key, config: augment.AugmentConfig, hw=(H, W)):
    """The reference's draws for ``key``, as ``augment_batch`` makes them,
    in the port's form."""
    h, w = hw
    k_crop, k_flip, k_bright, k_contrast = jax.random.split(key, 4)
    out = {}
    if config.crop_hw is not None:
        idx = None
        if config.scales:
            idx = int(jax.random.randint(jax.random.fold_in(k_crop, 2), (),
                                         0, len(config.scales)))
            out["scale_index"] = idx
        sh, sw = config.crop_size(idx, hw)
        out["y0"] = torch.from_numpy(np.array(jax.random.randint(
            k_crop, (B,), 0, max(h - sh, 0) + 1)))
        out["x0"] = torch.from_numpy(np.array(jax.random.randint(
            jax.random.fold_in(k_crop, 1), (B,), 0, max(w - sw, 0) + 1)))
    if config.flip_lr_prob > 0:
        out["flip"] = torch.from_numpy(np.array(jax.random.bernoulli(
            k_flip, config.flip_lr_prob, (B,))))
    for name, key_, amount in (("contrast", k_contrast, config.contrast),
                               ("brightness", k_bright, config.brightness)):
        if amount > 0:
            out[name] = torch.from_numpy(np.stack([np.asarray(
                jax.random.uniform(jax.random.fold_in(key_, i), (B, 1, 1, 1),
                                   minval=-amount, maxval=amount)).reshape(B)
                for i in range(len(IMAGES))]))
    return out


def run_both(case, seed, stereo=False):
    """(JAX's result, the port's) on make_batch's batch, as numpy."""
    kw = CASES[case]
    batch = make_batch(stereo)
    key = jax.random.PRNGKey(seed)
    want = augment_batch({k: jnp.asarray(v) for k, v in batch.items()}, key,
                         JaxAugmentConfig(**kw))
    config = augment.AugmentConfig(**kw)
    got = augment.apply({k: torch.from_numpy(v) for k, v in batch.items()},
                        jax_draws(key, config), config)
    return ({k: np.asarray(v) for k, v in want.items()},
            {k: v.numpy() for k, v in got.items()}, jax_draws(key, config))


def assert_images_close(got, want, exact, what):
    assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    if exact:
        assert diff.max() == 0, (what, int(diff.max()))
    else:
        assert diff.max() <= 1 and (diff > 0).mean() <= 0.01, (
            what, int(diff.max()), float((diff > 0).mean()))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("case", ["crop", "flip", "photometric", "seg_aspp"])
def test_apply_with_reference_draws_matches_augment_batch(case, seed):
    want, got, draws = run_both(case, seed)
    assert sorted(got) == sorted(want)
    if case == "flip":  # a flipped sample is the mirror of its input
        i = int(draws["flip"].int().argmax())
        assert bool(draws["flip"][i])
        np.testing.assert_array_equal(got["left"][i],
                                      make_batch()["left"][i, :, ::-1])
    photometric = case in ("photometric", "seg_aspp")
    for k in IMAGES:
        assert_images_close(got[k], want[k], not photometric, k)
    for k in ("seg_labels", "flow_gt", "flow_valid"):
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    if "crop_hw" in CASES[case]:
        assert got["left"].shape == (B, 24, 32, 3)


def test_scale_branches_match_augment_batch():
    """A key for each of the three zoom factors: crop 30x40, 24x32 and
    19x26 of the 40x56 frame, resized to 24x32 (bilinear images, nearest
    ground truth with its values scaled)."""
    config = augment.AugmentConfig(**CASES["scales"])
    seen = {}
    for seed in range(40):
        idx = jax_draws(jax.random.PRNGKey(seed), config)["scale_index"]
        seen.setdefault(idx, seed)
        if len(seen) == len(config.scales):
            break
    assert sorted(seen) == [0, 1, 2]
    for idx, seed in sorted(seen.items()):
        want, got, _ = run_both("scales", seed, stereo=True)
        resized = config.crop_size(idx, (H, W)) != config.crop_hw
        for k in IMAGES:
            assert_images_close(got[k], want[k], not resized, (idx, k))
        for k in ("seg_labels", "flow_gt", "flow_valid", "disp_gt",
                  "disp_valid"):
            assert got[k].shape[1:3] == (24, 32), k
            np.testing.assert_array_equal(got[k], want[k],
                                          err_msg=f"{idx} {k}")


def test_flip_is_skipped_with_disparity_ground_truth():
    want, got, draws = run_both("flip", 0, stereo=True)
    assert bool(draws["flip"].any())
    batch = make_batch(stereo=True)
    for k, v in batch.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
        np.testing.assert_array_equal(want[k], v, err_msg=k)


def test_draw_shapes_ranges_and_seeding():
    config = augment.AugmentConfig(**CASES["seg_aspp"],
                                   scales=(0.8, 1.0, 1.25))
    a = augment.draw(config, B, (H, W), torch.Generator().manual_seed(1))
    b = augment.draw(config, B, (H, W), torch.Generator().manual_seed(1))
    assert sorted(a) == ["brightness", "contrast", "flip", "scale_index",
                         "x0", "y0"]
    for k in a:
        assert torch.equal(torch.as_tensor(a[k]), torch.as_tensor(b[k])), k
    sh, sw = config.crop_size(a["scale_index"], (H, W))
    assert a["y0"].shape == (B,) and 0 <= int(a["y0"].min())
    assert int(a["y0"].max()) <= H - sh and int(a["x0"].max()) <= W - sw
    assert a["flip"].dtype == torch.bool
    for k in ("brightness", "contrast"):
        assert a[k].shape == (3, B) and float(a[k].abs().max()) <= 0.2
    # the reference's rule: a zoom never crops past the frame
    assert config.crop_size(0, (20, 30)) == (20, 30)
    assert not augment.AugmentConfig().enabled

"""The port's examples (``cerberusnet_torch/examples/``) against the JAX
package's ``examples/`` on the CPU.

* ``video_stream``: ``synthetic_stream`` yields the reference's frames; the
  port's ``stream("fast", ...)`` on the CPU returns the reference's stats
  with a positive p50 and throughput (as ``tests/test_tta.py`` asks of
  JAX's); its preprocessing of those uint8 frames is bit-equal to the
  reference's ``infer`` body's and its bf16 forward of the ``fast`` model
  on the same weights within twice JAX's own bf16 distance from float32
  (``tests/test_torch_model.py``'s rule; the float32 forward is the
  port's, which that file holds to JAX's within 1e-4).
* ``raft_anytime_inference``: one state at iterations 1/2/4/8 against
  JAX's ``RAFTFlowNet(iters=k)`` on the same weights in float32 within
  1e-5 of the largest JAX magnitude (``tests/test_torch_raft.py``'s rule);
  iteration k's level field is the 8-iteration run's k-th iterate; the
  example's ``main`` trains and prints an EPE per count.
* ``demo_end_to_end`` and ``migrate_from_torch`` run end to end into a
  temporary directory, the migration from a seeded ``TorchCerberus``
  checkpoint.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cerberusnet_tpu.models import raft as jr
from cerberusnet_torch.examples import demo_end_to_end as demo
from cerberusnet_torch.examples import migrate_from_torch as migrate
from cerberusnet_torch.examples import raft_anytime_inference as anytime
from cerberusnet_torch.examples import video_stream as vs
from cerberusnet_torch.testing import one_torch_thread  # noqa: F401
from cerberusnet_torch.train.trainer import build_model
from cerberusnet_torch.utils.visualization import read_png_u8
from cerberusnet_torch.weights import load_flax_params
from tests.jax_pairs import draw_params

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
from examples import video_stream as jax_vs  # noqa: E402

STREAM_HW = (64, 64)
STATS = ("model", "hw", "latency_ms_p50", "latency_ms_p99", "throughput_fps",
         "compute_bound_fps")
HEADS = ("seg_logits", "flow", "disp")
F32_RTOL = 1e-5


def test_synthetic_stream_is_the_references():
    got = list(vs.synthetic_stream(4, (16, 24), seed=3))
    want = list(jax_vs.synthetic_stream(4, (16, 24), seed=3))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert a.dtype == np.uint8 and np.array_equal(a, b)


def test_stream_runs_tiny_on_the_cpu():
    stats = vs.stream("fast", frames=6, hw=STREAM_HW, latency_samples=2,
                      verbose=False, device="cpu")
    assert tuple(stats) == STATS
    assert stats["latency_ms_p50"] > 0
    assert stats["throughput_fps"] and stats["throughput_fps"] > 0


def test_an_unknown_model_raises():
    with pytest.raises(ValueError, match="unknown model"):
        vs.make_model("tiny", torch.bfloat16)


def test_stream_forward_is_the_references_infer():
    """The reference's ``infer`` body (bf16) and the port's ``make_infer``
    on the same weights and uint8 frames. The float32 yardstick is the
    port's float32 forward of the same weights (``tests/test_torch_model.py``
    holds it to JAX's within 1e-4), which spares a second JAX compile."""
    frames = next(iter(jax_vs.synthetic_stream(2, STREAM_HW, seed=1)))
    jmodel = jax_vs.make_model("fast", jnp.bfloat16)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), *[
        jnp.zeros((1, *STREAM_HW, 3), jnp.bfloat16)] * 3)["params"]
    params = draw_params(shapes, 5)

    @jax.jit
    def infer(p, left, right, temporal):
        def prep(x):
            return (x.astype(jnp.bfloat16) / 255.0 - 0.5)[None]

        x = [prep(f) for f in (left, right, temporal)]
        return x, jmodel.apply({"params": p}, *x)

    jprep, jbf16 = infer(params, *map(jnp.asarray, frames))
    model = load_flax_params(vs.make_model("fast", torch.bfloat16),
                             params).eval()
    f32 = load_flax_params(vs.make_model("fast", torch.float32),
                           params).eval()
    triple = torch.from_numpy(np.stack(frames))
    for f, want in zip(triple, jprep):
        got = vs.prep(f)
        assert got.dtype == torch.bfloat16
        assert np.array_equal(got.float().numpy(),
                              np.asarray(want, np.float32))
    out, probe = vs.make_infer(model)(triple)
    ref, _ = vs.make_infer(f32, torch.float32)(triple)
    assert np.isfinite(probe.item())
    for key in HEADS:
        want = ref[key].numpy()
        jax_gap = np.linalg.norm(np.asarray(jbf16[key], np.float32) - want)
        port_gap = np.linalg.norm(out[key].float().numpy() - want)
        assert port_gap <= 2 * jax_gap, (key, port_gap, jax_gap)


# ------------------------------------------------------------ RAFT anytime


def test_raft_anytime_matches_jax_at_every_count():
    """One state, four iteration counts, in float32."""
    cfg = anytime.config()
    tiny = dict(encoder_channels=tuple(cfg.model.encoder_channels),
                fdim=cfg.model.raft_fdim, hdim=cfg.model.raft_hdim,
                cdim=cfg.model.raft_cdim,
                corr_levels=cfg.model.raft_corr_levels,
                radius=cfg.model.raft_radius)
    rng = np.random.RandomState(6)
    imgs = [rng.rand(1, *cfg.data.hw, 3).astype(np.float32)
            for _ in range(2)]
    models = {k: jr.RAFTFlowNet(iters=k, **tiny) for k in anytime.ITERS}
    params = draw_params(jax.eval_shape(
        models[1].init, jax.random.PRNGKey(0),
        *map(jnp.asarray, imgs))["params"], 7)
    want = jax.jit(lambda p, *x: {k: m.apply({"params": p}, *x)
                                  for k, m in models.items()})(
        params, *map(jnp.asarray, imgs))
    model, _ = build_model(cfg.model, None, torch.float32)
    state = load_flax_params(model, params).state_dict()
    got = anytime.anytime(cfg, state, [torch.from_numpy(i) for i in imgs])
    level = cfg.model.raft_level
    for k in anytime.ITERS:
        pairs = {"flow": (got[k]["flow"], want[k]["flow"]),
                 "flow_iterates": (got[k]["flow_iterates"],
                                   want[k]["flow_iterates"]),
                 "flow_pyramid": (got[k]["flow_pyramid"][level],
                                  want[k]["flow_pyramid"][level])}
        assert got[k]["flow_iterates"].shape[0] == k
        for key, (g, w) in pairs.items():
            w = np.asarray(w, np.float32)
            err = np.abs(g.numpy() - w).max() / max(np.abs(w).max(), 1e-30)
            assert err <= F32_RTOL, (k, key, err)
        # weight tying: the same computation as the longer run's first k
        assert torch.equal(got[k]["flow_pyramid"][level],
                           got[8]["flow_iterates"][k - 1])


def test_raft_anytime_main_trains_and_reports(monkeypatch):
    monkeypatch.setattr(anytime, "TRAIN_STEPS", 2)
    epe = anytime.main("cpu")
    assert sorted(epe) == list(anytime.ITERS)
    assert all(np.isfinite(v) and v > 0 for v in epe.values())


# -------------------------------------------------------------- the demos


def test_demo_end_to_end_runs_on_the_cpu(tmp_path):
    got = demo.main(str(tmp_path), "cpu")
    assert {"flow_epe", "disp_mae", "miou"} <= set(got["metrics"])
    assert all(np.isfinite(float(v)) for v in got["metrics"].values())
    h, w = demo.config(str(tmp_path)).data.hw
    panel = read_png_u8(got["panel"])  # image, seg, flow, disparity
    assert panel.shape == (4 * h, w, 3)
    assert {"model.pt2", "manifest.json"} <= {
        p.name for p in Path(got["export"]).iterdir()}
    assert any((tmp_path / "ckpt").iterdir())


def test_migration_runs_from_a_torch_checkpoint(tmp_path):
    from tools.torch_baseline import TorchCerberus

    torch.manual_seed(0)
    tiny = migrate.TINY
    tmodel = TorchCerberus(enc=tiny["encoder_channels"],
                           est=tiny["est_channels"], ctx=tiny["ctx_channels"],
                           fpn=tiny["fpn_channels"], num_classes=19)
    ckpt = tmp_path / "reference.pt"
    torch.save({"state_dict": tmodel.state_dict()}, ckpt)
    got = migrate.main(str(ckpt), str(tmp_path / "out"), "cpu")
    assert all(np.isfinite(float(v)) for v in got["metrics"].values())
    assert got["predictions"] and all(Path(p).is_file()
                                      for p in got["predictions"])
    assert (Path(got["export"]) / "model.pt2").is_file()

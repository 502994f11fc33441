"""The port's bench (cerberusnet_torch/bench.py) on the CPU: the headline
row's reduced scalar against the JAX package's CerberusNet on the same
weights and frames (the reduction of the root bench.py), each of bench.py
--all's rows at a small size returning what its JAX row reduces, and
main()'s output lines. Tiny widths, 64x64, one torch thread; nothing is
compiled (the AOTInductor row runs only on the card)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cerberusnet_torch import bench
from cerberusnet_torch.ops.cuda import correlation as cc
from cerberusnet_torch.testing import one_torch_thread  # noqa: F401
from cerberusnet_torch.weights import load_flax_params
from cerberusnet_tpu.models import CerberusNet as JaxCerberusNet
from tests.jax_pairs import TINY_RAFT, draw_params

HW = (64, 64)
TINY = dict(encoder_channels=(8, 12, 16, 16, 16, 16),
            est_channels=(16, 16, 12), ctx_channels=(16, 16),
            fpn_channels=16)
ENCODER = {"encoder_channels": TINY["encoder_channels"]}
RAFT_KW = {k: v for k, v in TINY_RAFT.items()
           if k in ("encoder_channels", "fdim", "hdim", "cdim")}


def test_headline_scalar_equals_jax():
    """bench.py's reduce_out (flow, disp and seg_logits means summed) of
    the JAX CerberusNet against the headline row's, float32: within the
    relative 1e-4 of tests/test_torch_model.py."""
    rng = np.random.RandomState(0)
    imgs = [rng.rand(1, *HW, 3).astype(np.float32) for _ in range(3)]
    jmodel = JaxCerberusNet(corr_impl="pure", **TINY)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            *[jnp.asarray(i) for i in imgs])["params"]
    params = draw_params(shapes, 1)
    out = jax.jit(lambda p, *x: jmodel.apply({"params": p}, *x))(
        params, *[jnp.asarray(i) for i in imgs])
    want = float(out["flow"].mean() + out["disp"].mean()
                 + out["seg_logits"].mean())

    row = bench.full3head(hw=HW, device="cpu", dtype=torch.float32,
                          model_kw=TINY)
    load_flax_params(row.model, params)
    got = row.reduce_out(row.fn(*[torch.from_numpy(i) for i in imgs]))
    assert got.dtype == torch.float32 and got.dim() == 0
    assert abs(float(got) - want) / max(abs(want), 1.0) <= 1e-4
    assert row.launches == {"corr2d_fwd": 5, "corr1d_fwd": 5}


# row: (its keywords at the small size, the outputs the JAX row
# reduces and their shapes, the row's launches a call on the card)
ROW_CASES = {
    "seg_fp32_fps": ({"model_kw": {**ENCODER, "fpn_channels": 16}},
                     {"seg_logits": (1, *HW, 19)}, {}),
    "stereo_bf16_fps": ({"model_kw": {**ENCODER,
                                      "est_channels": (16, 16, 12),
                                      "ctx_channels": (16, 16)}},
                        {"disp": (1, *HW, 1)}, {"corr1d_fwd": 5}),
    "flow_bf16_fps": ({"model_kw": {**ENCODER, "est_channels": (16, 16, 12),
                                    "ctx_channels": (16, 16)}},
                      {"flow": (1, *HW, 2)}, {"corr2d_fwd": 5}),
    "cerberus_dcv_bf16_fps": (
        {"model_kw": {**ENCODER, "fpn_channels": 16}},
        {"flow": (1, *HW, 2), "disp": (1, *HW, 1),
         "seg_logits": (1, *HW, 19)}, {"corr2d_fwd": 4, "corr1d_fwd": 3}),
    "raft_bf16_256x512_fps": ({"model_kw": RAFT_KW}, {"flow": (1, *HW, 2)},
                              {}),
    "cerberus_raft_bf16_256x512_6it_fps": (
        {"model_kw": {**RAFT_KW, "fpn_channels": 16}},
        {"flow": (1, *HW, 2), "disp": (1, *HW, 1),
         "seg_logits": (1, *HW, 19)}, {}),
    "cerberus_raft_bf16_512x1024_lv4_6it_fps": (
        {"model_kw": {**RAFT_KW, "fpn_channels": 16}, "level": 4},
        {"flow": (1, *HW, 2), "disp": (1, *HW, 1),
         "seg_logits": (1, *HW, 19)}, {}),
    "train_step_bf16_fps": (
        {"model_kw": {k: list(v) if isinstance(v, tuple) else v
                      for k, v in TINY.items()}},
        {"total": ()}, {k: 5 for k in cc.KERNELS}),
}


def test_rows_are_bench_py_rows():
    assert list(bench.ROWS) == [*ROW_CASES, "full3head_bf16_aoti_fps"]


@pytest.mark.parametrize("name", ROW_CASES)
def test_row_at_a_small_size(name):
    build, kw_of, iters_of = bench.ROWS[name]
    kwargs, want, launches = ROW_CASES[name]
    # bench.py's batch and timed calls from --batch 1 --iters 10
    kwargs = {**kw_of(1), **kwargs, "hw": HW}
    row = build(device="cpu", **kwargs)
    out = row.fn(*row.args)
    got = {k: tuple(out[k].shape) for k in want}
    assert got == want
    assert all(bool(torch.isfinite(out[k]).all()) for k in want)
    scalar = row.reduce_out(out)
    assert scalar.dim() == 0 and torch.isfinite(scalar)
    assert row.launches == launches
    assert row.frames == (2 if name.startswith("train") else 1)
    assert row.dtype == (torch.float32 if name.startswith("seg")
                         else torch.bfloat16)
    assert iters_of(10) == {"seg_fp32_fps": 40, "train_step_bf16_fps": 5,
                            "stereo_bf16_fps": 10, "flow_bf16_fps": 10,
                            "cerberus_dcv_bf16_fps": 10}.get(name, 6)


def test_train_row_batch_has_bench_py_labels():
    row = bench.train_step(hw=HW, device="cpu",
                           model_kw=ROW_CASES["train_step_bf16_fps"][0][
                               "model_kw"])
    batch = row.args[0]
    assert batch["left"].shape == (2, *HW, 3)
    assert not batch["seg_labels"].any() and not batch["flow_gt"].any()
    for k in ("flow_valid", "disp_gt", "disp_valid"):
        assert bool((batch[k] == 1).all()), k


FULL3HEAD = bench.full3head


def small_headline(batch=1, hw=bench.HW, device="cuda", **kw):
    return FULL3HEAD(batch, HW, device, model_kw=TINY)


def test_main_on_the_cpu_prints_bench_py_line(monkeypatch, capsys):
    monkeypatch.setattr(bench, "full3head", small_headline)
    assert bench.main(["--device", "cpu", "--iters", "2"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    last = json.loads(lines[-1])
    assert sorted(last) == ["metric", "unit", "value", "vs_baseline"]
    assert last["metric"] == "full3head_bf16_fps_per_chip_1024x512"
    assert last["unit"] == "frames/sec/chip" and last["vs_baseline"] is None
    assert last["value"] > 0
    details = json.loads(lines[-2])
    assert details["device"] == "cpu" and details["full3head_bf16_mfu"] is None
    assert details["full3head_bf16_flops"] > 0
    assert details["full3head_bf16_fps_rounds"] == 3
    lo, hi = details["full3head_bf16_fps_band"]
    assert lo <= details["full3head_bf16_fps"] <= hi


def test_all_records_a_failed_row_and_exits_1(monkeypatch, capsys, tmp_path):
    def broken(**kw):
        raise ValueError("no such model")

    def seg(device, **kw):
        return bench.seg(hw=HW, device=device,
                         model_kw={**ENCODER, "fpn_channels": 16})

    monkeypatch.setattr(bench, "full3head", small_headline)
    monkeypatch.setattr(bench, "ROWS", {
        "seg_fp32_fps": (seg, lambda b: {}, lambda i: 2),
        "broken_fps": (broken, lambda b: {}, lambda i: 2)})
    out = tmp_path / "details.json"
    assert bench.main(["--device", "cpu", "--all", "--iters", "2",
                       "--out", str(out)]) == 1
    details = json.loads(capsys.readouterr().out.strip().splitlines()[-2])
    assert details == json.loads(out.read_text())
    assert details["broken_fps"] is None
    assert "no such model" in details["broken_fps_error"]
    for key in ("", "_band", "_rounds", "_mfu", "_flops"):
        assert f"seg_fp32_fps{key}" in details
    assert details["seg_fp32_fps_flops"] > 0


def test_no_cuda_device_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the bench runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main([])

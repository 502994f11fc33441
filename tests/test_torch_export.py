"""The port's deployment export (cerberusnet_torch/export/aot.py,
Trainer.export, CerberusNet's stacked_input) against the JAX package's
(cerberusnet_tpu/export/aot.py) on the CPU, on the tiny CerberusNet of
tests/test_export.py with its weights carried across by
load_flax_params; and the fake implementations of the kernels' operators
(ops/library.py), which export traces through on the card; and the
CLI's export flags (``--export-dir``, ``--quant int8``,
``--export-stacked``) on the CPU, each artifact exported once for the
module (the stacked one held bit for bit to the separate-frame one).

Tolerances: the loaded program runs the eager forward's operators (1e-6);
against JAX's exported program the float32 outputs differ by summation
order (1e-4 relative L2, as the port's model tests hold them).
"""

import contextlib
import io
import json
import os

import jax
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from cerberusnet_tpu.export import load_exported as jax_load_exported
from cerberusnet_tpu.export.aot import export_cerberus as jax_export_cerberus
from cerberusnet_tpu.models import CerberusNet as JaxCerberusNet
from cerberusnet_torch import cli
from cerberusnet_torch.export import load_exported
from cerberusnet_torch.export.aot import export_cerberus
from cerberusnet_torch.models.cerberus import CerberusNet
from cerberusnet_torch.ops import correlation as corr
from cerberusnet_torch.ops import library
from cerberusnet_torch.ops.encoder_level import (
    encoder_level_bwd_plain,
    encoder_level_plain,
)
from cerberusnet_torch.quant import quantized_apply
from cerberusnet_torch.quant.ptq import rel_l2
from cerberusnet_torch.testing import one_torch_thread  # noqa: F401
from cerberusnet_torch.train.config import ExperimentConfig
from cerberusnet_torch.train.trainer import Trainer
from cerberusnet_torch.weights import load_flax_params

TINY = dict(encoder_channels=(8, 12, 16, 16, 16, 16), est_channels=(16, 16, 12),
            ctx_channels=(16, 16), fpn_channels=16)
HW = (64, 64)
HEADS = ("seg_logits", "flow", "disp")


def frames(seed, n=1):
    rng = np.random.RandomState(seed)
    return tuple(rng.rand(n, *HW, 3).astype(np.float32) for _ in range(3))


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """The JAX artifact of the tiny model (tests/test_export.py's), the
    port's of the same weights, the port model, and JAX's outputs on a
    batch."""
    d = tmp_path_factory.mktemp("export")
    jmodel = JaxCerberusNet(**TINY, corr_impl="pure")
    batch = frames(0)
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(0), *batch)
    jax_dir = jax_export_cerberus(variables, jmodel, hw=HW,
                                  dtype=jax.numpy.float32,
                                  out_dir=str(d / "jax"))
    jax_out = [np.asarray(v) for v in jax_load_exported(jax_dir).call(*batch)]
    model = load_flax_params(CerberusNet(**TINY),
                             jax.tree.map(np.asarray, variables["params"]))
    model = model.eval()
    port_dir = export_cerberus(model, hw=HW, dtype=torch.float32,
                               out_dir=str(d / "port"))
    return {"jax_dir": jax_dir, "jax_out": jax_out, "port_dir": port_dir,
            "model": model, "batch": batch}


_loaded = {}


def run(path, *inputs):
    """The artifact at ``path`` (loaded once) called on numpy inputs."""
    if path not in _loaded:
        _loaded[path] = load_exported(path).module()
    with torch.no_grad():
        return _loaded[path](*(torch.from_numpy(x) for x in inputs))


@pytest.mark.parametrize("head", range(3), ids=HEADS)
def test_loaded_program_matches_eager_and_jax(head, artifacts):
    got = run(artifacts["port_dir"], *artifacts["batch"])[head]
    with torch.no_grad():
        eager = artifacts["model"](
            *(torch.from_numpy(x) for x in artifacts["batch"]))[HEADS[head]]
    np.testing.assert_allclose(got.numpy(), eager.numpy(), rtol=1e-6,
                               atol=1e-6)
    want = torch.from_numpy(artifacts["jax_out"][head])
    assert got.shape == want.shape and got.dtype == want.dtype
    assert rel_l2(got, want) <= 1e-4


def test_manifest_matches_jax(artifacts):
    def manifest(d):
        with open(os.path.join(d, "manifest.json")) as f:
            return json.load(f)

    got, want = manifest(artifacts["port_dir"]), manifest(artifacts["jax_dir"])
    assert got["platforms"] == ["cpu"]
    assert got["inputs"] == want["inputs"]
    assert got["outputs"] == want["outputs"]
    assert os.path.getsize(os.path.join(artifacts["port_dir"], "model.pt2"))


def test_stacked_artifact_equals_separate(cli_exports):
    """The CLI's stacked artifact against its separate-frame one, of the
    same weights: bit for bit."""
    batch = frames(0)
    stacked_dir, separate_dir = cli_exports("stacked"), cli_exports("float")
    with open(os.path.join(stacked_dir, "manifest.json")) as f:
        assert json.load(f)["inputs"] == [{"shape": [3, *HW, 3],
                                           "dtype": "float32"}]
    sep = run(separate_dir, *batch)
    stk = run(stacked_dir, np.concatenate(batch, 0))
    for a, b in zip(sep, stk):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


# the calls the reference refuses, with its messages
STACKED_ERRORS = {
    "stacked_with_right": (True, (3, 1)),
    "stacked_not_3b": (True, (4,)),
    "separate_without_right": (False, (1,)),
}


@pytest.mark.parametrize("case", STACKED_ERRORS)
def test_stacked_errors_match_reference(case, artifacts):
    stacked, batches = STACKED_ERRORS[case]
    x = [np.zeros((b, *HW, 3), np.float32) for b in batches]
    jmodel = JaxCerberusNet(**TINY, corr_impl="pure", stacked_input=stacked)
    with pytest.raises(ValueError) as want:
        jmodel.init(jax.random.PRNGKey(0), *x)
    model = artifacts["model"]
    model.stacked_input = stacked
    try:
        with pytest.raises(ValueError) as got:
            model(*(torch.from_numpy(v) for v in x))
    finally:
        model.stacked_input = False
    assert str(got.value) == str(want.value)


def tiny_config(**train):
    return ExperimentConfig.from_dict({
        "name": "tiny-export",
        "model": {"variant": "cerberus", **{
            k: list(v) if isinstance(v, tuple) else v
            for k, v in TINY.items()}},
        "data": {"dataset": "synthetic", "hw": list(HW), "batch_size": 2,
                 "num_workers": 1, "synthetic_length": 2, "shuffle": False},
        "optim": {"lr": 1e-2, "schedule": "constant", "ema_decay": 0.5},
        "train": {"num_data_devices": 1, **train}})


def test_trainer_export_stacked_with_ema_weights(tmp_path):
    """Trainer.export(stacked=True) after a step: the artifact holds the
    EMA weights (not the masters, not the log-variances) behind one
    (3, H, W, 3) input; the other variants refuse stacked, and an unknown
    quant mode raises."""
    tr = Trainer(tiny_config(), device="cpu")
    tr.train_step(tr._loader(tr.dataset, 2).__iter__().__next__())
    assert any(not torch.equal(tr.ema[n], tr.masters[n]) for n in tr.names)
    out = tr.export(str(tmp_path / "stk"), stacked=True)
    with open(os.path.join(out, "manifest.json")) as f:
        man = json.load(f)
    assert man["inputs"] == [{"shape": [3, *HW, 3], "dtype": "float32"}]
    assert [o["shape"] for o in man["outputs"]] == [
        [1, *HW, 19], [1, *HW, 2], [1, *HW, 1]]
    batch = frames(1)
    got = run(out, np.concatenate(batch, 0))
    with torch.no_grad(), tr._eval_weights():
        want = tr.model(*(torch.from_numpy(x) for x in batch))
    for g, k in zip(got, HEADS):
        np.testing.assert_allclose(g.numpy(), want[k].numpy(), rtol=1e-5,
                                   atol=1e-6)
    with pytest.raises(ValueError, match="unknown quant mode"):
        tr.export(str(tmp_path / "bad"), quant="int4")
    tr.config.model.variant = "flow"
    with pytest.raises(ValueError, match="stacked export needs"):
        tr.export(str(tmp_path / "flow"), stacked=True)


# kernel: (operator, plain version, arguments of both, other arguments);
# shapes (B, H, W, C) as on the path (the 1-D correlations' D 24 at level
# 2, the dilated ones of the DCV heads, K9/K10 at level 2's widths)
F1, F2 = (2, 5, 9, 6), (2, 5, 9, 6)


def fake_cases():
    g2, g1 = (2, 5, 9, 81), (2, 5, 9, 25)
    x, y = (2, 8, 12, 16), (2, 4, 6, 32)
    k1, k2 = (3, 3, 16, 32), (3, 3, 32, 32)
    level = [x, k1, (32,), k2, (32,), k2, (32,)]
    return {
        "K1 corr2d_fwd": (library.corr2d_fwd, corr._correlation2d_plain,
                          [F1, F2], (4, 1)),
        "K2 corr2d_bwd_f1": (library.corr2d_bwd_f1,
                             corr._correlation2d_bwd_f1_plain, [g2, F2],
                             (4, 1)),
        "K3 corr2d_bwd_f2": (library.corr2d_bwd_f2,
                             corr._correlation2d_bwd_f2_plain, [g2, F1],
                             (4, 1)),
        "K4 corr1d_fwd": (library.corr1d_fwd, corr._correlation1d_plain,
                          [F1, F2], (24, 1)),
        "K5 corr1d_bwd_f1": (library.corr1d_bwd_f1,
                             corr._correlation1d_bwd_f1_plain, [g1, F2],
                             (24, 1)),
        "K6 corr1d_bwd_f2": (library.corr1d_bwd_f2,
                             corr._correlation1d_bwd_f2_plain, [g1, F1],
                             (24, 1)),
        "K7 corr2d_fwd dilated": (library.corr2d_fwd,
                                  corr._correlation2d_plain, [F1, F2], (4, 2)),
        "K8 corr1d_fwd dilated": (library.corr1d_fwd,
                                  corr._correlation1d_plain, [F1, F2], (4, 3)),
        "K9 encoder_level_fwd": (library.encoder_level_fwd,
                                 encoder_level_plain, level, ("pallas",)),
        "K10 encoder_level_bwd": (library.encoder_level_bwd,
                                  encoder_level_bwd_plain,
                                  [x, y, y, *level[1:]], (True,)),
    }


@pytest.mark.parametrize("kernel", fake_cases())
def test_fake_shapes_match_plain(kernel):
    """Each operator on fake tensors (no data, no device) gives the shapes
    and types its plain version gives on real ones."""
    op, plain, shapes, extra = fake_cases()[kernel]
    real = [torch.randn(s) for s in shapes]
    want = plain(*real, *extra[:2]) if "corr" in kernel else plain(*real)
    with FakeTensorMode() as mode:
        got = op(*(mode.from_tensor(t) for t in real), *extra)
    want = want if isinstance(want, (tuple, list)) else (want,)
    got = got if isinstance(got, (tuple, list)) else (got,)
    assert [tuple(t.shape) for t in got] == [tuple(t.shape) for t in want]
    # K10's weight gradients are float32 whatever the level's type
    assert [t.dtype for t in got] == [t.dtype for t in want]
    if kernel.startswith("K10"):
        with FakeTensorMode() as mode:
            dx, *_ = op(*(mode.from_tensor(t) for t in real), False)
        assert dx.shape == (0,)


@pytest.fixture
def operators_on_cpu(monkeypatch):
    """The card's path on the CPU: the models call the kernels' operators
    (as for a CUDA tensor), and each launch runs its kernel's plain
    version, the wrappers' counters included."""
    from cerberusnet_torch.models import encoder as encoder_module
    from cerberusnet_torch.ops.cuda import correlation as cc
    from cerberusnet_torch.ops.cuda import encoder_level as cl

    plain = {"corr2d_fwd": corr._correlation2d_plain,
             "corr1d_fwd": corr._correlation1d_plain}
    monkeypatch.setattr(cc, "_launch", lambda name, a, f, d, dil, nk, oc:
                        plain[name](a, f, d, dil))
    monkeypatch.setattr(cl, "_fwd", lambda x, k: encoder_level_plain(x, *k))
    monkeypatch.setattr(corr, "_dispatch", lambda f1, f2, impl: False)

    def level(x, *params, grad="xla"):
        return library.encoder_level_fwd(x.contiguous(), *params, grad)

    monkeypatch.setattr(encoder_module, "encoder_level", level)
    cc.reset_launches()
    cl.reset_launches()
    yield {"corr": cc.launches, "level": cl.launches}
    cc.reset_launches()
    cl.reset_launches()


# model: (its class and keywords, the operators its program holds)
OPERATOR_PROGRAMS = {
    "cerberus_pallas_levels": (
        "cerberus", {"pallas_levels": 3},
        {"corr2d_fwd": 5, "corr1d_fwd": 5, "encoder_level_fwd": 3}),
    "cerberus_dcv": ("cerberus_dcv", {}, {"corr2d_fwd": 4, "corr1d_fwd": 3}),
}


@pytest.mark.parametrize("name", OPERATOR_PROGRAMS)
def test_program_holds_the_kernels_operators(name, operators_on_cpu,
                                             tmp_path):
    """Traced through the operators (their fake implementations), the
    program holds one call of an operator per kernel launch; loaded back
    and called, it launches the kernels (here their plain versions) that
    many times and gives the eager forward's outputs."""
    from cerberusnet_torch.models.dcv_flow import CerberusDCV
    from cerberusnet_torch.weights import init_params

    variant, kwargs, want = OPERATOR_PROGRAMS[name]
    cls = CerberusNet if variant == "cerberus" else CerberusDCV
    model = init_params(cls(**TINY, **kwargs),
                        torch.Generator().manual_seed(0)).eval()
    out = export_cerberus(model, hw=HW, dtype=torch.float32,
                          out_dir=str(tmp_path / name))
    program = load_exported(out)
    held = {}
    for node in program.graph.nodes:
        if str(node.target).startswith("cerberus."):
            op = str(node.target).split(".")[1]
            held[op] = held.get(op, 0) + 1
    assert held == want
    counts = operators_on_cpu
    before = {**counts["corr"](), **counts["level"]()}
    batch = [torch.from_numpy(x) for x in frames(4)]
    with torch.no_grad():
        got = program.module()(*batch)
    after = {**counts["corr"](), **counts["level"]()}
    assert {k: after[k] - before[k] for k in after
            if after[k] != before[k]} == want
    with torch.no_grad():
        eager = model(*batch)
    for g, k in zip(got, HEADS):
        torch.testing.assert_close(g, eager[k], rtol=0, atol=0)

# ---------------------------------------------------- the CLI's export flags
# ``--export-dir``, with ``--quant int8`` and with ``--export-stacked`` on
# the CPU (``--device cpu``) at tiny widths, each one call of ``cli.main``
# that writes ``model.pt2`` and ``manifest.json``; the float artifact
# agrees with the trainer's forward, the int8 one with its int8 model

CLI_CONFIG = {
    "name": "tiny-cli-export",
    "model": {"encoder_channels": [8, 12, 16, 16, 16, 16],
              "est_channels": [16, 16, 12], "ctx_channels": [16, 16],
              "fpn_channels": 16},
    "data": {"hw": list(HW), "batch_size": 2, "num_workers": 1,
             "synthetic_length": 2, "shuffle": False},
    "optim": {"schedule": "constant"},
    "train": {"log_every": 1000}}
# flags: the artifact's inputs
CLI_CASES = {"float": ([], [[1, *HW, 3]] * 3),
             "int8": (["--quant", "int8"], [[1, *HW, 3]] * 3),
             "stacked": (["--export-stacked"], [[3, *HW, 3]])}


@pytest.fixture(scope="module")
def cli_exports(tmp_path_factory):
    """``cli_exports(case)``: the directory ``cli.main`` exported the
    case's artifact to (run once for the module, its standard output
    checked)."""
    root = tmp_path_factory.mktemp("cli_export")
    cfg = root / "tiny.json"
    cfg.write_text(json.dumps(CLI_CONFIG))
    done = {}

    def get(case):
        if case not in done:
            out = str(root / case)
            said = io.StringIO()
            with contextlib.redirect_stdout(said):
                assert cli.main(["--config", str(cfg), "--device", "cpu",
                                 "--export-dir", out,
                                 *CLI_CASES[case][0]]) == 0
            assert f"exported AOT artifact to {out}" in said.getvalue()
            done[case] = out
        return done[case]
    return get


@pytest.mark.parametrize("case", CLI_CASES)
def test_cli_exports(case, cli_exports):
    _, inputs = CLI_CASES[case]
    out = cli_exports(case)
    assert os.path.getsize(os.path.join(out, "model.pt2"))
    with open(os.path.join(out, "manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["platforms"] == ["cpu"]
    assert [i["shape"] for i in manifest["inputs"]] == inputs
    assert [o["shape"][-1] for o in manifest["outputs"]] == [19, 2, 1]
    if case == "stacked":
        return  # held to the separate frames by test_stacked_artifact_...
    # the program against the trainer the CLI built, seeded the same way:
    # its forward, or its int8 model under quantized_apply
    rng = np.random.RandomState(0)
    inputs = [rng.rand(*s).astype(np.float32) for s in inputs]
    tr = Trainer(ExperimentConfig.from_dict(CLI_CONFIG), device="cpu")
    got = run(out, *inputs)
    with torch.no_grad():
        x = [torch.from_numpy(v) for v in inputs]
        if case == "int8":
            want = quantized_apply(tr.deploy_model("int8"), *x)
        else:
            want = tr.model.eval()(*x)
    for g, k in zip(got, HEADS):
        np.testing.assert_allclose(g.numpy(), want[k].numpy(), rtol=1e-5,
                                   atol=1e-6)

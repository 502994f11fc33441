"""The C++ runner's host-side I/O (cerberusnet_torch/export/runner_io.py)
against the JAX package's (tools/runner_io.py, whose bfloat16 goes through
ml_dtypes where the port's goes through torch): the raw tensor files byte
for byte, the dump reader, the --serve framing (answers and errors), and
inputs written from an export's manifest. Exact comparisons: both sides
write the same bits (round-to-nearest-even to bfloat16)."""

import io
import json
import os
from types import SimpleNamespace

import ml_dtypes
import numpy as np
import pytest
import torch

from cerberusnet_torch.export import runner_io
from cerberusnet_torch.export.aot import (
    DeployOutputs,
    export_inference,
    save_exported,
)
from cerberusnet_torch.testing import one_torch_thread  # noqa: F401
from tools import runner_io as ref_io


def edge_values():
    """float32 values that test a bfloat16 cast: random bit patterns (NaNs
    left out: their payloads are not the cast's business), rounding ties,
    infinities, signed zeros and subnormals."""
    rng = np.random.RandomState(0)
    bits = rng.randint(0, 2**32, 4000, dtype=np.uint64).astype(np.uint32)
    vals = bits.view(np.float32)
    vals = vals[~np.isnan(vals)]
    ties = (rng.randint(0, 2**16, 64).astype(np.uint32) << 16 | 0x8000)
    special = np.array([np.inf, -np.inf, 0.0, -0.0, 1e-40, -3e-39, 1.0,
                        3.3895314e38], np.float32)
    return np.concatenate([vals, ties.view(np.float32), special])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
def test_write_bin_matches_the_reference(tmp_path, dtype):
    a = (np.random.RandomState(1).randint(-2**31, 2**31 - 1, (6, 7, 3),
                                          dtype=np.int64).astype(np.int32)
         if dtype == "int32" else edge_values())
    ref = ref_io.write_bin(str(tmp_path / "ref.bin"), a, dtype)
    got = runner_io.write_bin(str(tmp_path / "got.bin"), a, dtype)
    with open(ref, "rb") as f1, open(got, "rb") as f2:
        assert f1.read() == f2.read()
    back = runner_io.read_bin(got, a.shape, dtype)
    assert back.dtype == runner_io.DTYPES[dtype]
    want = np.asarray(ref_io.read_bin(ref, a.shape, dtype))
    if dtype == "bfloat16":
        assert np.array_equal(back.view(torch.int16).numpy(),
                              want.view(np.int16))
    else:
        assert np.array_equal(back.numpy(), want)


def test_write_bin_takes_tensors(tmp_path):
    a = torch.from_numpy(edge_values()[:512]).reshape(8, 64)
    ref = ref_io.write_bin(str(tmp_path / "ref.bin"), a.numpy(), "bfloat16")
    got = runner_io.write_bin(str(tmp_path / "got.bin"),
                              a.to(torch.bfloat16), "bfloat16")
    assert open(ref, "rb").read() == open(got, "rb").read()


def test_read_outputs_of_a_dump_written_by_hand(tmp_path):
    rng = np.random.RandomState(2)
    outs = [rng.randn(1, 4, 6, 19).astype(np.float32),
            rng.randn(1, 4, 6, 2).astype(ml_dtypes.bfloat16),
            rng.randint(0, 255, (3, 5)).astype(np.uint8)]
    meta = []
    for i, (o, dtype) in enumerate(zip(outs, ("float32", "bfloat16",
                                              "uint8"))):
        (tmp_path / f"output_{i}.bin").write_bytes(o.tobytes())
        meta.append({"file": f"output_{i}.bin", "dtype": dtype,
                     "shape": list(o.shape)})
    (tmp_path / "outputs.json").write_text(json.dumps(meta) + "\n")
    got = runner_io.read_outputs(str(tmp_path))
    ref = ref_io.read_outputs(str(tmp_path))
    assert [list(t.shape) for t in got] == [m["shape"] for m in meta]
    for g, r in zip(got, ref):
        assert np.array_equal(g.float().numpy(),
                              np.asarray(r).astype(np.float32))


def serve_answer(outs, dtypes):
    """An answer in the runner's --serve framing."""
    buf = f"OK {len(outs)}\n".encode()
    for o, dtype in zip(outs, dtypes):
        raw = o.tobytes()
        buf += (f"OUT {dtype} {o.ndim} {' '.join(map(str, o.shape))} "
                f"{len(raw)}\n").encode() + raw
    return buf


def test_serve_framing_as_the_reference_reads_it():
    rng = np.random.RandomState(3)
    outs = [rng.randn(1, 3, 5, 19).astype(np.float32),
            rng.randn(1, 3, 5, 2).astype(ml_dtypes.bfloat16),
            rng.randn(2).astype(np.float32)]
    stream = serve_answer(outs, ("float32", "bfloat16", "float32"))
    got = runner_io.read_response(io.BytesIO(stream + stream))
    ref_client = ref_io.ServeClient.__new__(ref_io.ServeClient)
    ref_client.proc = SimpleNamespace(stdout=io.BytesIO(stream))
    ref = ref_client._read_response()
    assert len(got) == len(ref) == 3
    for g, r in zip(got, ref):
        assert list(g.shape) == list(r.shape)
        assert np.array_equal(g.float().numpy(), r.astype(np.float32))


def test_serve_framing_errors():
    with pytest.raises(RuntimeError, match="unknown request 'HELLO'"):
        runner_io.read_response(io.BytesIO(b"ERR unknown request 'HELLO'\n"))
    with pytest.raises(RuntimeError, match="closed its stdout"):
        runner_io.read_response(io.BytesIO(b""))
    short = serve_answer([np.zeros(4, np.float32)], ["float32"])[:-3]
    with pytest.raises(RuntimeError, match="short output read"):
        runner_io.read_response(io.BytesIO(short))


class Pair(torch.nn.Module):
    def forward(self, left, right):
        return {"flow": left.float() - right.float(),
                "disp": left.float().mean(-1, keepdim=True)}


def test_inputs_round_trip_through_the_manifest(tmp_path):
    example = (torch.zeros((1, 4, 6, 3), dtype=torch.bfloat16),
               torch.zeros((1, 4, 6, 3), dtype=torch.bfloat16))
    d = save_exported(export_inference(DeployOutputs(Pair()), example),
                      str(tmp_path / "art"))
    manifest = runner_io.manifest(d)
    assert manifest["platforms"] == ["cpu"]
    assert manifest["inputs"] == [{"shape": [1, 4, 6, 3],
                                   "dtype": "bfloat16"}] * 2
    assert manifest["outputs"] == [{"shape": [1, 4, 6, 3],
                                    "dtype": "float32"},
                                   {"shape": [1, 4, 6, 1],
                                    "dtype": "float32"}]
    # the port's verify inputs are the reference's: one RandomState, a
    # float32 uniform draw per input, cast by the writer
    inputs = runner_io.random_inputs(manifest["inputs"], seed=5)
    rng = np.random.RandomState(5)
    for i, (t, spec) in enumerate(zip(inputs, manifest["inputs"])):
        ref = ref_io.write_bin(str(tmp_path / f"ref_{i}.bin"),
                               rng.rand(*spec["shape"]).astype(np.float32),
                               spec["dtype"])
        got = runner_io.write_bin(str(tmp_path / f"in_{i}.bin"), t,
                                  spec["dtype"])
        assert open(ref, "rb").read() == open(got, "rb").read()
        back = runner_io.read_bin(got, spec["shape"], spec["dtype"])
        assert torch.equal(back, t.to(torch.bfloat16))
    assert os.path.getsize(tmp_path / "in_0.bin") == 1 * 4 * 6 * 3 * 2

"""The C++ operator library (csrc/cerberus_ops.cc) against the Python
operators (ops/library.py): a package written in a Python process names
each operator by the schema its custom_op inferred, so the C++ definitions
must be those strings, for the forward operators an inference artifact
holds, each implemented for CUDA and counted. The tile table both bindings
of K9 read (csrc/tc_levels.cuh) holds the rows the kernels were built
from; and the build names of the runner follow its sources."""

import re

import pytest
import torch

from cerberusnet_torch.export import runner as runner_build
from cerberusnet_torch.ops import build
from cerberusnet_torch.ops import library  # noqa: F401  the operators
from cerberusnet_torch.ops.cuda import encoder_level as cl

SOURCE = runner_build.OPS_SOURCE.read_text()
# the rows of TC_LEVELS when the table stood in encoder_level.cu
TC_ROWS = [(3, 16, 16, 32, 16, 16, 2, 256, 1),
           (16, 32, 16, 16, 16, 16, 1, 512, 1),
           (32, 64, 8, 8, 8, 16, 1, 512, 0)]


def block(head):
    """The body of the ``head { ... }`` block of the source."""
    start = SOURCE.index(head)
    return SOURCE[start:SOURCE.index("\n}\n", start)]


def defined():
    """{name: schema} of the m.def(...) calls in TORCH_LIBRARY(cerberus),
    the adjacent string literals joined."""
    out = {}
    for call in re.findall(r"m\.def\((.*?)\);", block("TORCH_LIBRARY(cerberus"),
                           re.S):
        schema = "".join(re.findall(r'"((?:[^"\\]|\\.)*)"', call))
        out[schema[:schema.index("(")]] = schema
    return out


def python_forwards():
    """The forward operators ops/library.py registers."""
    names = [n.split("::")[1] for n in torch._C._dispatch_get_all_op_names()
             if n.startswith("cerberus::")]
    assert "encoder_level_bwd" in names  # the namespace was read
    return {n for n in names if n.endswith("_fwd")}


def test_defined_set_is_the_python_forwards():
    assert set(defined()) == python_forwards() == {
        "corr2d_fwd", "corr1d_fwd", "encoder_level_fwd"}


@pytest.mark.parametrize("name", ["corr2d_fwd", "corr1d_fwd",
                                  "encoder_level_fwd"])
def test_schema_equals_the_python_operator(name):
    python = str(getattr(torch.ops.cerberus, name).default._schema)
    assert python == "cerberus::" + defined()[name]


def test_each_operator_has_a_cuda_kernel_and_a_counter():
    impls = re.findall(r'm\.impl\("(\w+)"',
                       block("TORCH_LIBRARY_IMPL(cerberus, CUDA"))
    assert sorted(impls) == sorted(defined())
    assert "TORCH_LIBRARY_IMPL(cerberus, CPU" not in SOURCE  # no plain path
    counted = re.findall(r'std::strcmp\(name, "(\w+)"\) == 0',
                         block('extern "C" int64_t cerberus_ops_launches'))
    assert sorted(counted) == sorted(defined())
    # each operator calls the kernel library's C entry point
    for entry in ("corr2d_fwd(", "corr1d_fwd(", "encoder_level_tc_fwd(",
                  "encoder_level_fwd("):
        assert f"int {entry}" in SOURCE


def c_signature(ret, params):
    """(return type, parameter types) of a C declaration, names dropped."""
    types = [re.sub(r"\s*\b\w+$", "", " ".join(p.split()))
             for p in params.split(",")]
    return " ".join(ret.split()), [t.replace(" *", "*") for t in types]


def test_encoder_level_entry_points_declared_as_defined():
    # the operator library declares the kernel library's C entry points
    # itself: each encoder-level one as encoder_level.cu defines it
    decls = block('extern "C" {')
    declared = {name: c_signature(ret, params) for ret, name, params in
                re.findall(r"([\w\s\*]+?)\s*\b(encoder_level\w*)\(([^)]*)\);",
                           decls)}
    cu = (build.CSRC_DIR / "encoder_level.cu").read_text()
    defined_ = {name: c_signature(ret, params) for ret, name, params in
                re.findall(r'extern "C" ([\w\s\*]+?)\s*\b(encoder_level\w*)'
                           r"\(([^)]*)\)\s*\{", cu)}
    assert {"encoder_level_fwd", "encoder_level_tc_fwd",
            "encoder_level_tc_fwd_workspace"} <= set(declared)
    for name, sig in declared.items():
        assert sig == defined_[name], name
    # the weights are packed by the kernel library alone
    assert "permute" not in SOURCE and "pack_b" not in SOURCE


def test_tile_table_moved_whole():
    assert cl._tc_rows() == TC_ROWS
    assert '#include "tc_levels.cuh"' in SOURCE
    assert "#define TC_LEVELS" not in (build.CSRC_DIR
                                       / "encoder_level.cu").read_text()
    # both libraries' names cover the header
    assert cl.TC_LEVELS_HEADER.suffix == ".cuh"
    assert cl.TC_LEVELS_HEADER.parent == build.CSRC_DIR


def test_runner_name_follows_its_sources(tmp_path, monkeypatch):
    before = runner_build.runner_path()
    assert before == runner_build.runner_path()
    copies = []
    for src in runner_build.RUNNER_SOURCES:
        copy = tmp_path / src.name
        copy.write_bytes(src.read_bytes())
        copies.append(copy)
    monkeypatch.setattr(runner_build, "RUNNER_SOURCES", tuple(copies))
    assert runner_build.runner_path() == before
    copies[0].write_text(copies[0].read_text() + "\n// edited\n")
    assert runner_build.runner_path() != before
    assert runner_build.runner_path().parent == build.BUILD_DIR

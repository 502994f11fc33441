"""Host-side I/O for the C++ runner (``csrc/runner.cc``,
``cerberus_runner``), the port's copy of ``tools/runner_io.py``.

The runner reads and writes raw little-endian tensor files (``.bin``, the
manifest's shapes and dtypes byte for byte) and speaks a framed protocol
in ``--serve`` mode. These helpers write and read those files and frames,
and hold a run of the runner against the same package loaded into Python
(``torch._inductor.aoti_load_package``), where the kernels are the
operators of ``ops/library.py`` on the same nvcc-built libraries. bfloat16
goes through torch (no numpy dtype holds it): written as the bits of
``tensor.to(torch.bfloat16)``, read back through an int16 view.

    python -m cerberusnet_torch.export.runner_io package <export_dir>
    python -m cerberusnet_torch.export.runner_io verify <export_dir> [--pngs]
    python -m cerberusnet_torch.export.runner_io serve-verify <export_dir>

``package`` compiles the export with AOTInductor (``export/aot.py``
``package_for_runner``); the others build the runner (and, for
``--device cuda``, the operator library) on first use
(``export/runner.py``), run it on seeded inputs and compare its outputs
with the Python-loaded package's, printing one JSON report.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from cerberusnet_torch.export.aot import RUNNER_PACKAGE, package_for_runner

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16, "int32": torch.int32,
          "uint8": torch.uint8}


def _bytes(t: torch.Tensor) -> bytes:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy().tobytes()


def write_bin(path: str, array, dtype: str) -> str:
    """``array`` (numpy or torch) cast to ``dtype`` as raw little-endian
    bytes in ``path``; returns ``path``."""
    t = torch.as_tensor(np.asarray(array) if not torch.is_tensor(array)
                        else array)
    with open(path, "wb") as f:
        f.write(_bytes(t.to(DTYPES[dtype])))
    return path


def read_bin(path: str, shape, dtype: str) -> torch.Tensor:
    """The tensor of ``shape`` and ``dtype`` that ``path`` holds."""
    with open(path, "rb") as f:
        raw = bytearray(f.read())
    return torch.frombuffer(raw, dtype=DTYPES[dtype]).reshape(list(shape))


def read_outputs(dump_dir: str) -> list:
    """The runner's ``--dump-outputs``: ``outputs.json`` and its files."""
    with open(os.path.join(dump_dir, "outputs.json")) as f:
        meta = json.load(f)
    return [read_bin(os.path.join(dump_dir, m["file"]), m["shape"],
                     m["dtype"]) for m in meta]


def manifest(export_dir: str) -> dict:
    with open(os.path.join(export_dir, "manifest.json")) as f:
        return json.load(f)


def read_response(stream) -> list:
    """One ``--serve`` answer from a binary stream: "OK <n>", then for each
    output "OUT <dtype> <ndims> <dims...> <nbytes>" and its bytes. Raises
    RuntimeError on "ERR <msg>" or a closed or short stream."""
    def line():
        raw = stream.readline()
        if not raw:
            raise RuntimeError("runner closed its stdout")
        return raw.decode().rstrip("\n")

    header = line()
    if not header.startswith("OK "):
        raise RuntimeError(f"runner error: {header!r}")
    outs = []
    for _ in range(int(header.split()[1])):
        parts = line().split()
        if parts[0] != "OUT":
            raise RuntimeError(f"runner answered {parts!r}")
        ndims = int(parts[2])
        shape = [int(x) for x in parts[3:3 + ndims]]
        nbytes = int(parts[3 + ndims])
        raw = stream.read(nbytes)
        if len(raw) != nbytes:
            raise RuntimeError("short output read")
        outs.append(torch.frombuffer(bytearray(raw), dtype=DTYPES[parts[1]])
                    .reshape(shape))
    return outs


def runner_command(export_dir: str, runner: str, ops: str | None,
                   device: str) -> list:
    cmd = [str(runner), "--model", export_dir, "--device", device]
    return cmd + (["--ops", str(ops)] if ops else [])


def default_binaries(device: str):
    """(runner, operator library or None): built on first use; the library
    only for the card."""
    from cerberusnet_torch.export import runner as build

    ops = build.build_ops()[0] if device == "cuda" else None
    return build.build_runner()[0], ops


class ServeClient:
    """A ``cerberus_runner --serve`` process: started once, then requests
    against its warm package."""

    def __init__(self, export_dir: str, runner: str, ops: str | None = None,
                 device: str = "cuda"):
        self.manifest = manifest(export_dir)
        self.proc = subprocess.Popen(
            [*runner_command(export_dir, runner, ops, device), "--serve"],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE)
        ready = self.proc.stdout.readline().decode().split()
        if ready[:1] != ["READY"]:
            self.proc.kill()
            self.proc.wait()
            raise RuntimeError(f"runner not ready: {ready!r}")
        self.n_in, self.n_out = int(ready[1]), int(ready[2])

    def infer(self, tensors) -> list:
        """One request with raw tensors, cast to the manifest's dtypes."""
        if len(tensors) != self.n_in:
            raise ValueError(f"expected {self.n_in} inputs")
        self.proc.stdin.write(b"INFER\n")
        for t, spec in zip(tensors, self.manifest["inputs"]):
            self.proc.stdin.write(_bytes(torch.as_tensor(t).to(
                DTYPES[spec["dtype"]])))
        self.proc.stdin.flush()
        return read_response(self.proc.stdout)

    def infer_pngs(self, paths) -> list:
        """One request with PNG files, decoded by the runner."""
        self.proc.stdin.write(f"PNGS {','.join(paths)}\n".encode())
        self.proc.stdin.flush()
        return read_response(self.proc.stdout)

    def close(self) -> int:
        """Sends QUIT; the process's exit code."""
        try:
            self.proc.stdin.write(b"QUIT\n")
            self.proc.stdin.flush()
        except BrokenPipeError:
            pass
        self.proc.stdin.close()
        try:
            return self.proc.wait(timeout=60)
        finally:
            self.proc.stdout.close()


def run_runner(export_dir: str, runner: str, ops: str | None, device: str,
               files, dump_dir: str, pngs: bool = False,
               iters: int = 1) -> dict:
    """One ``cerberus_runner`` run on ``files`` (``--inputs``, or
    ``--pngs``) dumping its outputs into ``dump_dir``: its JSON line.
    Raises RuntimeError with its stderr when it fails."""
    cmd = [*runner_command(export_dir, runner, ops, device), "--iters",
           str(iters), "--pngs" if pngs else "--inputs", ",".join(files),
           "--dump-outputs", dump_dir]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"runner exited {proc.returncode}: "
                           f"{proc.stderr[-3000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def load_package(export_dir: str):
    """The package loaded into this process (its operators are
    ``ops/library.py``'s)."""
    return torch._inductor.aoti_load_package(
        os.path.join(export_dir, RUNNER_PACKAGE))


def python_outputs(package, inputs, device: str) -> list:
    with torch.no_grad():
        outs = package(*[t.to(device) for t in inputs])
    return [o.cpu() for o in (outs if isinstance(outs, (list, tuple))
                              else [outs])]


def compare(got, want, rtol: float = 1e-2) -> dict:
    """Each output of ``got`` against ``want``: bit equality, relative L2
    and the largest difference; "ok" where every output is within
    ``rtol``."""
    rows = []
    for g, w in zip(got, want):
        g32, w32 = g.float(), w.float()
        rows.append({
            "shape": list(g.shape), "dtype": str(g.dtype)[6:],
            "bit_equal": g.dtype == w.dtype and torch.equal(g, w),
            "rel_l2": ((g32 - w32).norm() / w32.norm().clamp_min(1e-12))
            .item(),
            "max_abs": (g32 - w32).abs().max().item()})
    return {"outputs": rows, "bit_equal": all(r["bit_equal"] for r in rows),
            "ok": len(got) == len(want) and all(
                r["rel_l2"] <= rtol for r in rows)}


def random_inputs(spec_list, seed: int) -> list:
    """Seeded uniform [0, 1) float32 tensors of the manifest's shapes (cast
    by the writer)."""
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.rand(*s["shape"]).astype(np.float32))
            for s in spec_list]


def verify(export_dir: str, runner: str, ops: str | None = None,
           device: str = "cuda", seed: int = 0, iters: int = 1,
           package=None) -> dict:
    """The runner on seeded inputs (``--inputs``) against the package loaded
    into this process on the same inputs."""
    specs = manifest(export_dir)["inputs"]
    tmp = os.path.join(export_dir, "_verify")
    os.makedirs(tmp, exist_ok=True)
    inputs = [t.to(DTYPES[s["dtype"]])
              for t, s in zip(random_inputs(specs, seed), specs)]
    files = [write_bin(os.path.join(tmp, f"in_{i}.bin"), t, s["dtype"])
             for i, (t, s) in enumerate(zip(inputs, specs))]
    run = run_runner(export_dir, runner, ops, device, files, tmp,
                     iters=iters)
    package = package or load_package(export_dir)
    report = compare(read_outputs(tmp), python_outputs(package, inputs,
                                                       device))
    return {**report, "runner": run}


def png_frames(export_dir: str, seed: int) -> tuple:
    """(paths, inputs): seeded random RGB PNGs of the manifest's frames,
    written with the port's PNG writer, and the Python path's inputs from
    them: ``data/io`` decode, ``encodings.preprocess_image``, the cast to
    the manifest dtype (stacked: the frames concatenated)."""
    from cerberusnet_torch.data import encodings
    from cerberusnet_torch.data import io as data_io

    specs = manifest(export_dir)["inputs"]
    stacked = len(specs) == 1 and specs[0]["shape"][0] > 1
    k = specs[0]["shape"][0] if stacked else len(specs)
    _, h, w, _ = specs[0]["shape"]
    tmp = os.path.join(export_dir, "_verify_png")
    os.makedirs(tmp, exist_ok=True)
    rng = np.random.RandomState(seed)
    paths, frames = [], []
    for i in range(k):
        path = os.path.join(tmp, f"in_{i}.png")
        data_io.write_image_u8(path, rng.randint(0, 256, (h, w, 3), np.uint8))
        paths.append(path)
        img = torch.from_numpy(data_io.read_image_u8(path))[None]
        frames.append(encodings.preprocess_image(img))
    dtype = DTYPES[specs[0]["dtype"]]
    inputs = ([torch.cat(frames).to(dtype)] if stacked
              else [f.to(dtype) for f in frames])
    return paths, inputs


def verify_pngs(export_dir: str, runner: str, ops: str | None = None,
                device: str = "cuda", seed: int = 0, package=None) -> dict:
    """The runner's own PNG path (``--pngs``: decode, normalise, cast in
    C++) against the Python path's on the same files."""
    paths, inputs = png_frames(export_dir, seed)
    tmp = os.path.dirname(paths[0])
    run = run_runner(export_dir, runner, ops, device, paths, tmp, pngs=True)
    package = package or load_package(export_dir)
    report = compare(read_outputs(tmp), python_outputs(package, inputs,
                                                       device))
    return {**report, "runner": run}


def verify_serve(export_dir: str, runner: str, ops: str | None = None,
                 device: str = "cuda", seed: int = 0, requests: int = 3,
                 package=None) -> dict:
    """``requests`` seeded INFER requests and one PNGS request to one warm
    ``--serve`` process, each against the package loaded here; the wall ms
    of each request, and the process's exit code after QUIT."""
    package = package or load_package(export_dir)
    specs = manifest(export_dir)["inputs"]
    client = ServeClient(export_dir, runner, ops, device)
    rows = []
    try:
        for r in range(requests):
            inputs = [t.to(DTYPES[s["dtype"]]) for t, s in
                      zip(random_inputs(specs, seed + r), specs)]
            t0 = time.perf_counter()
            got = client.infer(inputs)
            ms = (time.perf_counter() - t0) * 1e3
            rows.append({"request": "INFER", "wall_ms": ms,
                         **compare(got, python_outputs(package, inputs,
                                                       device))})
        paths, inputs = png_frames(export_dir, seed)
        t0 = time.perf_counter()
        got = client.infer_pngs(paths)
        ms = (time.perf_counter() - t0) * 1e3
        rows.append({"request": "PNGS", "wall_ms": ms,
                     **compare(got, python_outputs(package, inputs, device))})
    finally:
        rc = client.close()
    return {"requests": rows, "rc": rc,
            "bit_equal": all(r["bit_equal"] for r in rows),
            "ok": rc == 0 and all(r["ok"] for r in rows)}


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="runner_io")
    sub = ap.add_subparsers(dest="cmd", required=True)
    sub.add_parser("package").add_argument("export_dir")
    for name in ("verify", "serve-verify"):
        p = sub.add_parser(name)
        p.add_argument("export_dir")
        p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
        p.add_argument("--runner", help="cerberus_runner (built if absent)")
        p.add_argument("--ops", help="libcerberus_ops.so (built if absent)")
        if name == "verify":
            p.add_argument("--pngs", action="store_true",
                           help="the runner's PNG path instead of raw inputs")
    args = ap.parse_args(argv)
    if args.cmd == "package":
        print(package_for_runner(args.export_dir))
        return 0
    runner, ops = default_binaries(args.device)
    runner, ops = args.runner or runner, args.ops or ops
    check = (verify_serve if args.cmd == "serve-verify" else
             verify_pngs if args.pngs else verify)
    report = check(args.export_dir, runner, ops, args.device)
    print(json.dumps(report))
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())

"""Data parallelism across processes: the port's counterpart of the
``data`` axis of ``cerberusnet_tpu/parallel/mesh.py``.

The reference builds a ('data', 'spatial') mesh of devices under one
controller: ``shard_batch`` places the host's global batch over it, and
GSPMD makes every reduction over the batch global and inserts the
gradient psum. PyTorch's idiom is one process per card, so each process
holds its slice of the batch and the reductions are made global by hand:

* ``make_mesh`` is this process's place in an initialised
  ``torch.distributed`` group: rank, size and device (``DataMesh``). A
  process outside any group is a mesh of one, whose collectives are the
  identity, so a single process computes exactly what it did before.
* ``shard_batch`` is rank r's samples [r B/N, (r+1) B/N) of a host batch
  of B.
* ``DataMesh.sum``, ``mean`` and ``max`` are the batch's reductions over
  every rank, differentiable, for the losses; ``mean_grads`` all-reduces
  the float32 gradients in a few flat buckets; ``sum_`` adds up metric
  accumulators; ``barrier`` waits for every rank.
* ``launch`` starts N ranks (the ``spawn`` start method, a collective
  time limit) and returns their results; a rank that raises, or does not
  end in time, makes it raise.

The gradient convention. ``sum`` is an all-reduce, and its backward is the
all-reduce of the upstream gradients, its adjoint. Every rank computes the
same global loss and calls ``backward``, so the N ranks' upstream
gradients are equal, the backward sums N copies of them, and each rank's
gradient is N times its own samples' share. The all-reduce of the
parameters' gradients is therefore a mean (``mean_grads``), not a sum.

The spatial axis (H-sharding, ``train.num_spatial_devices > 1``) is not
ported (ROADMAP A11b).
"""

from __future__ import annotations

import dataclasses
import datetime
import multiprocessing
import os
import pickle
import queue
import shutil
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

# a collective's time limit (torch.distributed's default is 30 minutes)
COLLECTIVE_TIMEOUT_S = 1800.0
# the gradients' all-reduce: flat float32 buckets of at most this size
BUCKET_BYTES = 32 * 2**20


def _group():
    """(size, rank) of this process's group, (1, 0) outside one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def check_cards(n: int):
    """Raises ValueError when ``n`` ranks, one a CUDA device, exceed the
    visible devices (the reference fails at ``make_mesh``'s reshape)."""
    cards = torch.cuda.device_count()
    if n > cards:
        raise ValueError(
            f"train.num_data_devices={n} asks for {n} CUDA devices, one a "
            f"rank, and {cards} are visible")


def data_ranks(num_data: int, device) -> int:
    """The ranks a launcher starts for ``train.num_data_devices``: itself
    when positive, else every visible CUDA device ("cuda", a card a rank,
    which must exist) or one."""
    device = torch.device(device)
    if device.type != "cuda" or device.index is not None:
        return max(num_data, 1)
    n = num_data if num_data > 0 else torch.cuda.device_count()
    check_cards(n)
    return n


class _AllSum(torch.autograd.Function):
    """The sum over ranks; its backward sums the upstream gradients over
    ranks (the module docstring's convention)."""

    @staticmethod
    def forward(ctx, x):
        y = torch.clone(x, memory_format=torch.contiguous_format)
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, g):
        g = torch.clone(g, memory_format=torch.contiguous_format)
        dist.all_reduce(g)
        return g


@dataclasses.dataclass(frozen=True)
class DataMesh:
    """This process's place on the data axis: ``rank`` of ``size`` ranks,
    its ``device``, and whether it is in a process group (``distributed``,
    also for a group of one: the collectives then run on one rank)."""

    rank: int = 0
    size: int = 1
    device: torch.device = torch.device("cpu")
    distributed: bool = False

    def sum(self, x):
        """The sum of ``x`` over ranks, differentiable."""
        return _AllSum.apply(x) if self.distributed else x

    def mean(self, x):
        """The mean of ``x`` over its elements on every rank (each rank
        holds as many); ``x.mean()`` outside a group."""
        if not self.distributed:
            return x.mean()
        return self.sum(x.sum()) / (x.numel() * self.size)

    def max(self, x):
        """The largest element of ``x`` over ranks, ``x.amax()`` outside a
        group. The gradient is shared equally among the elements equal to
        it on every rank, as JAX's ``max`` shares it among ties."""
        if not self.distributed:
            return x.amax()
        with torch.no_grad():
            top = x.amax().clone()
            dist.all_reduce(top, op=dist.ReduceOp.MAX)
            hit = (x == top).to(x.dtype)
        share = self.sum((x * hit).sum()) / self.sum(hit.sum())
        return top + (share - share.detach())

    @torch.no_grad()
    def sum_(self, x):
        """Sums ``x`` over ranks in place (no gradient); returns it."""
        if self.distributed:
            dist.all_reduce(x)
        return x

    @torch.no_grad()
    def mean_grads(self, grads):
        """Replaces each tensor of ``grads`` (float32, the same names in
        the same order on every rank) by its mean over ranks, in flat
        buckets of at most ``BUCKET_BYTES``: one all-reduce a bucket.
        Returns the number of buckets."""
        if not self.distributed:
            return 0
        buckets, cur, nbytes = [], [], 0
        for g in grads:
            if cur and nbytes + g.numel() * 4 > BUCKET_BYTES:
                buckets.append(cur)
                cur, nbytes = [], 0
            cur.append(g)
            nbytes += g.numel() * 4
        if cur:
            buckets.append(cur)
        for bucket in buckets:
            flat = torch.cat([g.reshape(-1) for g in bucket])
            dist.all_reduce(flat)
            flat.div_(self.size)
            parts = flat.split([g.numel() for g in bucket])
            torch._foreach_copy_(bucket, [p.view(g.shape)
                                          for p, g in zip(parts, bucket)])
        return len(buckets)

    def barrier(self):
        if self.distributed:
            dist.barrier()

    def shard(self, n: int) -> slice:
        """This rank's rows of a global batch of ``n``."""
        if n % self.size:
            raise ValueError(
                f"batch size {n} is not divisible by the data-parallel mesh "
                f"axis ({self.size} devices); adjust data.batch_size")
        b = n // self.size
        return slice(self.rank * b, (self.rank + 1) * b)


SINGLE = DataMesh()


def make_mesh(num_data: int = 0, device="cuda") -> DataMesh:
    """This process's ``DataMesh`` for ``train.num_data_devices`` =
    ``num_data`` ranks (0: every rank of the group; a process outside a
    group is a mesh of one). ``device`` "cuda" without an index means a
    card a rank, the rank's own (``LOCAL_RANK``, else the rank); with an
    index the ranks share it. Raises ValueError when the ranks asked for
    exceed the visible cards or differ from the group's size."""
    device = torch.device(device)
    size, rank = _group()
    distributed = dist.is_available() and dist.is_initialized()
    n = num_data if num_data > 0 else size
    if device.type == "cuda" and device.index is None:
        check_cards(n)
        if distributed:
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK",
                                                             rank)))
    if n != size:
        raise ValueError(
            f"train.num_data_devices={n} asks for {n} data ranks, and this "
            f"process is one of {size}: start the ranks with "
            f"`python -m cerberusnet_torch.cli`, parallel.launch or torchrun")
    return DataMesh(rank, size, device, distributed)


def shard_batch(batch: dict, mesh: DataMesh) -> dict:
    """This rank's slice (dim 0) of a host batch dict; raises the
    reference's ValueError when the batch does not divide."""
    rows = mesh.shard(len(next(iter(batch.values()))))
    return {k: v[rows] for k, v in batch.items()}


# ------------------------------------------------------------- launcher


def _rank_main(fn, rank, nprocs, backend, init, args, results):
    """A spawned rank: joins the group, runs ``fn(*args)`` and sends
    (rank, ok, pickled result or the traceback)."""
    os.environ["LOCAL_RANK"] = str(rank)
    try:
        if backend == "nccl":
            torch.cuda.set_device(rank)
        dist.init_process_group(
            backend, init_method=init, rank=rank, world_size=nprocs,
            timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
        msg = (rank, True, pickle.dumps(fn(*args)))
    except BaseException:  # sent to the launcher, which raises it
        msg = (rank, False, traceback.format_exc())
    results.put(msg)
    if dist.is_initialized():
        dist.destroy_process_group()


def _stop(procs, grace):
    procs = [p for p in procs if p.pid is not None]  # the started ones
    for p in procs:
        p.join(grace)
    for p in procs:
        if p.is_alive():
            p.terminate()
            p.join(5)
        if p.is_alive():
            p.kill()
            p.join()


def launch(fn, nprocs: int, args=(), backend: str = "gloo",
           timeout: float | None = None) -> list:
    """Runs ``fn(*args)`` in ``nprocs`` spawned ranks of one process group
    and returns their results, by rank. ``fn`` is an importable function
    (not a closure) and its result picklable; each rank builds its mesh
    with ``make_mesh``. ``backend``: "nccl" (a card a rank: rank r sets
    ``cuda:r``), "gloo" (the CPU, or ranks that share one card, which NCCL
    refuses: gloo stages CUDA tensors through the host). Every collective
    raises after ``COLLECTIVE_TIMEOUT_S``. A rank that raises, dies,
    or has not ended ``timeout`` seconds after the start makes this raise
    (RuntimeError, TimeoutError) once every rank is stopped."""
    ctx = multiprocessing.get_context("spawn")
    store = tempfile.mkdtemp(prefix="cerberus_dp_")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, nprocs, backend,
                               f"file://{os.path.join(store, 'store')}",
                               args, results))
             for r in range(nprocs)]
    deadline = None if timeout is None else time.monotonic() + timeout
    got, gone = {}, {}
    ok = False
    try:
        for p in procs:
            p.start()
        while len(got) < nprocs:
            try:
                rank, fine, payload = results.get(timeout=1.0)
            except queue.Empty:
                now = time.monotonic()
                for r, p in enumerate(procs):
                    if r in got or p.exitcode is None:
                        continue
                    # a rank's message reaches the queue before it exits
                    gone.setdefault(r, now)
                    if p.exitcode != 0 or now - gone[r] > 30:
                        raise RuntimeError(
                            f"rank {r} of {nprocs} exited with code "
                            f"{p.exitcode} and no result")
                if deadline is not None and now > deadline:
                    raise TimeoutError(
                        f"ranks {sorted(set(range(nprocs)) - set(got))} of "
                        f"{nprocs} did not end within {timeout} s")
                continue
            if not fine:
                raise RuntimeError(f"rank {rank} of {nprocs} failed:\n"
                                   f"{payload}")
            got[rank] = pickle.loads(payload)
        ok = True
    finally:
        _stop(procs, 60 if ok else 0)
        results.close()
        shutil.rmtree(store, ignore_errors=True)
    return [got[r] for r in range(nprocs)]

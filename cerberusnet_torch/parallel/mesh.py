"""Data and spatial parallelism across processes: the port's counterpart
of the ``data`` and ``spatial`` axes of ``cerberusnet_tpu/parallel/mesh.py``.

The reference builds a ('data', 'spatial') mesh of devices under one
controller: ``shard_batch`` places the host's global batch over it (the
samples over 'data', image rows over 'spatial'), and GSPMD makes every
reduction global, inserts the gradient psum and the convolutions' halo
exchanges. PyTorch's idiom is one process per card, so each process holds
its piece of the batch and the reductions and halos are made by hand:

* ``make_mesh`` is this process's place in an initialised
  ``torch.distributed`` group (``DataMesh``): rank, size, device, and its
  (data, spatial) coordinates on a D x S grid, rank = d S + s as the
  reference's reshape lays them out, with a process group of its S
  spatial peers for the halos (``parallel/halo.py``). A process outside
  any group is a mesh of one, whose collectives are the identity, so a
  single process computes exactly what it did before.
* ``shard_batch`` is rank (d, s)'s samples [d B/D, (d+1) B/D) of a host
  batch of B and, of every image-like entry (three dimensions or more),
  its band of rows (``DataMesh.rows``).
* The bands. A frame's rows at pyramid level l are XLA's "SAME" stride-2
  chain h_0 = H, h_l = ceil(h_(l-1) / 2) (``level_extents``; a spatial
  mesh cannot be made without them). The coarsest level's h_L rows split
  as evenly as they go, the first h_L mod S ranks holding a row more; a
  finer level's band is the rows whose parent lies in the coarser band,
  parent(i) = floor((i + pt) / 2) with pt the stride-2 block's top pad at
  that extent (1 where it is odd): band [a, b) at level l owns rows
  [max(0, 2a - pt), min(h, 2b - pt)) at level l - 1 (``nested_bands``).
  So a stride-2 block's band is its input's band with one row below (and
  rank 0's zero row above at an odd extent), every rank holds a row at
  every level, and where H is a multiple of 2^L every level's band is f
  times the coarsest one's, f = 2^(L - l). Each rank's heights differ
  from level to level (checked when the mesh is made), so
  ``band_heights``, ``band_start`` and ``frame_rows`` find a band's level
  from its height in this rank's table.
* ``DataMesh.sum``, ``mean`` and ``max`` are reductions over every rank,
  differentiable, for the losses; ``spatial_sum`` is the sum over the
  spatial peers; ``mean_grads`` all-reduces the float32 gradients in a few
  flat buckets; ``sum_`` adds up metric accumulators; ``barrier`` waits
  for every rank.
* ``launch`` starts N ranks (the ``spawn`` start method, a collective
  time limit) and returns their results; a rank that raises, or does not
  end in time, makes it raise.

The gradient convention. ``sum`` is an all-reduce, and its backward is the
all-reduce of the upstream gradients, its adjoint. Every rank computes the
same global loss and calls ``backward``, so the N ranks' upstream
gradients are equal, the backward sums N copies of them, and each rank's
gradient is N times its own share. The all-reduce of the parameters'
gradients is therefore a mean (``mean_grads``), not a sum. The spatial
axis keeps the convention when two rules hold: every global reduction runs
over all D x S ranks, and every halo exchange sends the gradient of a
borrowed row back to the rank that owns it, where it is added (a value
computed alike on every spatial peer, such as ASPP's image mean, comes
from ``spatial_sum``, whose backward is the same all-reduce). Then a
rank's parameter gradient is N times its band's share, and the mean over
all ranks is the whole frame's and the global batch's gradient.
"""

from __future__ import annotations

import dataclasses
import datetime
import itertools
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


# the depth of the chain a mesh given only its coarsest level's rows R
# stands for: an H that is a multiple of 2^6 (the encoder's six levels)
GRID_LEVELS = 6


def level_extents(h: int, levels: int) -> tuple:
    """A frame's rows at each of ``levels`` + 1 pyramid levels, full
    resolution first: XLA's "SAME" stride-2 chain, h_l = ceil(h_(l-1) /
    2)."""
    out = [h]
    for _ in range(levels):
        out.append(-(-out[-1] // 2))
    return tuple(out)


def nested_bands(extents: tuple, n: int) -> tuple:
    """The ``n`` ranks' rows at each level of ``extents`` (full
    resolution first): the coarsest split as evenly as it goes, the first
    ranks a row more, and each finer band the rows whose parent lies in
    the coarser band (the module docstring's rule)."""
    q, extra = divmod(extents[-1], n)
    heights = tuple(q + (s < extra) for s in range(n))
    ends = list(itertools.accumulate(heights))
    table = [heights]
    for h in reversed(extents[:-1]):
        ends = [min(h, 2 * e - h % 2) for e in ends]
        table.append(tuple(e - a for a, e in zip([0] + ends[:-1], ends)))
    return tuple(reversed(table))


def _group():
    """(size, rank) of this process's group, (1, 0) outside one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def _setting(num_spatial: int) -> str:
    """The config keys whose product is the ranks asked for."""
    return ("train.num_data_devices" if num_spatial == 1 else
            "train.num_data_devices x train.num_spatial_devices")


def check_cards(n: int, num_spatial: int = 1):
    """Raises ValueError when ``n`` ranks, one a CUDA device, exceed the
    visible devices (the reference fails at ``make_mesh``'s reshape)."""
    cards = torch.cuda.device_count()
    if n > cards:
        raise ValueError(
            f"{_setting(num_spatial)}={n} asks for {n} CUDA devices, one a "
            f"rank, and {cards} are visible")


def data_ranks(num_data: int, device, num_spatial: int = 1) -> int:
    """The ranks a launcher starts for ``train.num_data_devices`` x
    ``train.num_spatial_devices``: their product when ``num_data`` is
    positive, else every visible CUDA device ("cuda", a card a rank, which
    must exist and be a multiple of ``num_spatial``) or ``num_spatial``."""
    device = torch.device(device)
    if device.type != "cuda" or device.index is not None:
        return max(num_data, 1) * num_spatial
    if num_data > 0:
        n = num_data * num_spatial
    else:
        n = torch.cuda.device_count()
        if n % num_spatial:
            raise ValueError(f"{n} CUDA devices not divisible by "
                             f"train.num_spatial_devices={num_spatial}")
    check_cards(n, num_spatial)
    return n


class _AllSum(torch.autograd.Function):
    """The sum over the ranks of ``group`` (every rank: None); its backward
    sums the upstream gradients over the same ranks (the module
    docstring's convention)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = torch.clone(x, memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = torch.clone(g, memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


@dataclasses.dataclass(frozen=True, eq=False)
class DataMesh:
    """This process's place on the mesh: ``rank`` of ``size`` ranks, its
    ``device``, whether it is in a process group (``distributed``, also for
    a group of one: the collectives then run on one rank), the spatial
    axis's extent S (``spatial_size``) and the process group of this
    rank's S spatial peers (``spatial_group``, ranks d S .. d S + S - 1).
    Its data coordinate is ``data_rank`` of ``data_size``, its spatial one
    ``spatial_rank``. ``extents``: the frame's rows at each pyramid level,
    full resolution first (``level_extents``), which set the bands (the
    module docstring), the coarsest's (``coarsest_rows``) at least one a
    spatial rank when S > 1; given ``coarsest_rows`` R alone, the chain of
    an H that is a multiple of 2^``GRID_LEVELS``, R 2^k rows at level
    ``GRID_LEVELS`` - k. ``bands``: the S ranks' rows at each level."""

    rank: int = 0
    size: int = 1
    device: torch.device = torch.device("cpu")
    distributed: bool = False
    spatial_size: int = 1
    spatial_group: object = None
    coarsest_rows: int = 0
    extents: tuple = ()
    bands: tuple = dataclasses.field(default=(), init=False, repr=False)

    def __post_init__(self):
        if not self.banded:
            return
        extents = tuple(self.extents) or tuple(
            self.coarsest_rows << k for k in range(GRID_LEVELS, -1, -1))
        if self.extents and self.coarsest_rows not in (0, extents[-1]):
            raise ValueError(f"coarsest_rows={self.coarsest_rows} is not the "
                             f"coarsest of the extents {extents}")
        if extents[-1] < self.spatial_size:
            raise ValueError(
                f"a spatial mesh axis of {self.spatial_size} ranks needs the "
                f"coarsest level's rows, at least one a rank "
                f"(coarsest_rows={extents[-1]})")
        bands = nested_bands(extents, self.spatial_size)
        for s, own in enumerate(zip(*bands)):
            if len(set(own)) < len(own):
                raise ValueError(
                    f"spatial rank {s} holds bands of {own} rows at the "
                    f"levels of {extents}: a band's height does not name "
                    f"its level")
        object.__setattr__(self, "extents", extents)
        object.__setattr__(self, "coarsest_rows", extents[-1])
        object.__setattr__(self, "bands", bands)

    @property
    def data_rank(self) -> int:
        return self.rank // self.spatial_size

    @property
    def data_size(self) -> int:
        return self.size // self.spatial_size

    @property
    def spatial_rank(self) -> int:
        return self.rank % self.spatial_size

    @property
    def banded(self) -> bool:
        """Whether image rows are split over more than one rank."""
        return self.spatial_size > 1

    def sum(self, x):
        """The sum of ``x`` over ranks, differentiable."""
        return _AllSum.apply(x, None) if self.distributed else x

    def spatial_sum(self, x):
        """The sum of ``x`` over this rank's spatial peers,
        differentiable: a value of the whole frame, equal on each peer."""
        return _AllSum.apply(x, self.spatial_group) if self.banded else x

    def mean(self, x, count: int | None = None):
        """The mean of ``x`` over its elements on every rank;
        ``x.mean()`` outside a group. Each rank holds as many elements
        unless ``count``, the number of elements on all ranks together,
        is given."""
        if not self.distributed:
            return x.mean()
        return self.sum(x.sum()) / (x.numel() * self.size
                                    if count is None else count)

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
        """This rank's samples of a global batch of ``n``."""
        if n % self.data_size:
            raise ValueError(
                f"batch size {n} is not divisible by the data-parallel mesh "
                f"axis ({self.data_size} devices); adjust data.batch_size")
        b = n // self.data_size
        return slice(self.data_rank * b, (self.data_rank + 1) * b)

    def split(self, h: int) -> tuple:
        """The S spatial ranks' rows of a map of ``h`` rows, one of the
        frame's level extents, by spatial rank (the module docstring's
        rule)."""
        if not self.banded:
            return (h,)
        if h not in self.extents:
            raise ValueError(
                f"{h} rows are no level of the frame's {self.extents} (the "
                f"coarsest level's {self.coarsest_rows}, the spatial mesh "
                f"axis)")
        return self.bands[self.extents.index(h)]

    def band_heights(self, hb: int) -> tuple:
        """The S ranks' rows at the level where this rank holds ``hb``."""
        if not self.banded:
            return (hb,)
        own = [heights[self.spatial_rank] for heights in self.bands]
        if hb not in own:
            raise ValueError(
                f"a band of {hb} rows on a rank of {own[-1]} coarsest rows "
                f"(the spatial mesh axis: this rank's bands {tuple(own)})")
        return self.bands[own.index(hb)]

    def band_start(self, hb: int) -> int:
        """The frame row where this rank's band of ``hb`` rows starts."""
        return sum(self.band_heights(hb)[:self.spatial_rank])

    def frame_rows(self, hb: int) -> int:
        """The frame's rows at the level of this rank's band of ``hb``."""
        return sum(self.band_heights(hb))

    def rows(self, h: int) -> slice:
        """This rank's band of ``h`` image rows."""
        heights = self.split(h)
        start = sum(heights[:self.spatial_rank])
        return slice(start, start + heights[self.spatial_rank])

    def band(self, batch: dict) -> dict:
        """This rank's band of rows (dimension 1) of every entry of
        ``batch`` with three dimensions or more (images, labels, flow,
        disparity and their masks); the others as they are."""
        if not self.banded:
            return batch
        return {k: v[:, self.rows(v.shape[1])] if getattr(v, "ndim", 0) >= 3
                else v for k, v in batch.items()}


SINGLE = DataMesh()


def _spatial_groups(size: int, spatial: int):
    """This rank's group of spatial peers, made on every rank of the
    world (``dist.new_group`` is collective): one group per data
    coordinate."""
    rank = dist.get_rank()
    mine = None
    for d in range(size // spatial):
        ranks = list(range(d * spatial, (d + 1) * spatial))
        group = dist.new_group(ranks)
        if rank in ranks:
            mine = group
    return mine


def make_mesh(num_data: int = 0, device="cuda", num_spatial: int = 1,
              coarsest_rows: int = 0, extents: tuple = ()) -> DataMesh:
    """This process's ``DataMesh`` for ``train.num_data_devices`` =
    ``num_data`` x ``train.num_spatial_devices`` = ``num_spatial`` ranks
    (``num_data`` 0: every rank of the group, divided by ``num_spatial``; a
    process outside a group is a mesh of one). ``device`` "cuda" without
    an index means a card a rank, the rank's own (``LOCAL_RANK``, else the
    rank); with an index the ranks share it. Raises ValueError when the
    ranks asked for exceed the visible cards or differ from the group's
    size. ``extents``: the frame's rows at each pyramid level
    (``level_extents``), which set the spatial bands, or
    ``coarsest_rows`` alone for an H that is a multiple of 2^6; one of them
    is required when ``num_spatial`` > 1."""
    device = torch.device(device)
    size, rank = _group()
    distributed = dist.is_available() and dist.is_initialized()
    if num_data <= 0 and size % num_spatial:
        raise ValueError(f"{size} ranks not divisible by "
                         f"train.num_spatial_devices={num_spatial}")
    n = num_data * num_spatial if num_data > 0 else size
    if device.type == "cuda" and device.index is None:
        check_cards(n, num_spatial)
        if distributed:
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK",
                                                             rank)))
    if n != size:
        raise ValueError(
            f"{_setting(num_spatial)}={n} asks for {n} "
            f"{'data ranks' if num_spatial == 1 else 'ranks'}, and this "
            f"process is one of {size}: start the ranks with `python -m cerberusnet_torch.cli`, "
            f"parallel.launch or torchrun")
    group = _spatial_groups(size, num_spatial) if num_spatial > 1 else None
    if num_spatial == 1:
        coarsest_rows, extents = 0, ()
    return DataMesh(rank, size, device, distributed, num_spatial, group,
                    coarsest_rows, tuple(extents))


def shard_batch(batch: dict, mesh: DataMesh) -> dict:
    """This rank's piece of a host batch dict: its samples (dim 0) and, on
    a spatial mesh, its band of rows (dim 1) of every entry with three
    dimensions or more, as the reference's ``shard_batch`` places them;
    raises the reference's ValueError when the batch does not divide."""
    return mesh.band(shard_samples(batch, mesh))


def shard_samples(batch: dict, mesh: DataMesh) -> dict:
    """This rank's samples (dim 0) of a host batch dict, whole frames: what
    a trainer takes, which augments and preprocesses the frame before it
    keeps its band."""
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

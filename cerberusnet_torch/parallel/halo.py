"""Halo exchanges of the spatial mesh axis (``train.num_spatial_devices``):
the rows a rank borrows from the ranks that hold the neighbouring bands of
an image, which GSPMD inserts for the reference.

A rank of a spatial mesh (``parallel/mesh.py``'s ``DataMesh``, S peers)
holds its band of rows of every map, the bands of one map of unequal
heights where the coarsest level's rows do not split evenly
(``DataMesh.band_heights``). An op that reads r rows across its output
row (a 3x3 convolution at dilation r, a bilinear resize, a shifted
difference) runs on the band with r rows of halo on each side:

* ``halo_rows(x, top, bottom, mesh, fill)`` is the band with ``top`` rows
  above it and ``bottom`` below, taken from the peers that own them, from
  more than one peer when the halo is taller than a band. Rows outside the
  frame are zeros (``fill="zero"``, a convolution's padding) or copies of
  the frame's first or last row (``"edge"``, a resize's clamp). Its
  backward sends each borrowed row's gradient to its owner, which adds it
  to its own; a clamped row's goes to the frame's first or last row.
* ``gather_rows(x, mesh)`` is the whole frame on every peer (the warp's
  source, which any row may read); its backward sums the peers' gradients
  and keeps the band's (a reduce-scatter).

Both are made of the collectives every backend runs on CUDA tensors:
``all_gather`` for the rows, ``all_reduce`` for their gradients (gloo, for
ranks that share a card, stages them through the host; its ``send`` and
``recv`` take CPU tensors only). Each rank contributes its first and last
rows, the peers' pieces are gathered, and each rank picks the rows it
needs, so one exchange serves any halo height; with S = 2 it moves what a
point-to-point exchange would. ``all_gather`` takes pieces of one shape,
so where the bands differ in height each piece is padded with zero rows
to the largest and cut after the gather. Gradients are summed in float32
and cast once. An exchange that fails raises: there is no fallback.

On a mesh of one (no spatial axis) ``halo_rows`` is the local padding and
``gather_rows`` the identity, with no collective. The models do not call
them there: they keep their own padding, so one process computes exactly
what it did before the axis existed.

``STATS`` counts the collectives this process made (forward and backward)
and the bytes it put into them (``reset_stats``, ``stats``).
"""

from __future__ import annotations

import functools

import torch
import torch.distributed as dist

FILLS = ("zero", "edge")
# the collectives of the exchanges and the bytes this process contributed
STATS = {"exchanges": 0, "bytes": 0}


def reset_stats():
    STATS.update(exchanges=0, bytes=0)


def stats() -> dict:
    return dict(STATS)


def _count(t):
    STATS["exchanges"] += 1
    STATS["bytes"] += t.numel() * t.element_size()


def _pad_rows(t, dim: int, rows: int):
    """``t`` with zero rows appended along ``dim`` up to ``rows``."""
    short = rows - t.shape[dim]
    if not short:
        return t
    shape = list(t.shape)
    shape[dim] = short
    return torch.cat([t, t.new_zeros(shape)], dim)


def _all_gather(t, mesh):
    """The S peers' ``t`` (equal shapes), by spatial rank."""
    t = t.contiguous()
    if not mesh.banded:
        return [t]
    out = [torch.empty_like(t) for _ in range(mesh.spatial_size)]
    _count(t)
    dist.all_gather(out, t, group=mesh.spatial_group)
    return out


def _all_reduce(t, mesh):
    """The sum of ``t`` over the S peers, in place."""
    if mesh.banded:
        _count(t)
        dist.all_reduce(t, group=mesh.spatial_group)
    return t


@functools.lru_cache(maxsize=None)
def _halo_index(heights: tuple, top: int, bottom: int, s: int, fill: str):
    """(rows above, rows below) of band ``s`` of bands of ``heights`` rows,
    as indices into the source ``_HaloRows`` builds: each peer's piece (its
    last t_r and first b_r rows, t_r = min(top, h_r), b_r = min(bottom,
    h_r), each part padded to the largest peer's) in spatial order, then
    the band's own first and last rows, then a row of zeros."""
    tmax = min(top, max(heights))
    bmax = min(bottom, max(heights))
    n = len(heights)
    pieces = n * (tmax + bmax)
    first, last, zero = pieces, pieces + 1, pieces + 2
    starts = [sum(heights[:r]) for r in range(n + 1)]
    frame = starts[n]

    def source(g):
        if not 0 <= g < frame:
            if fill == "zero":
                return zero
            if g < 0 and s == 0:
                return first
            if g >= frame and s == n - 1:
                return last
            g = 0 if g < 0 else frame - 1
        r = max(i for i in range(n) if starts[i] <= g)
        row, hr = g - starts[r], heights[r]
        t, b = min(top, hr), min(bottom, hr)
        if r < s and row >= hr - t:  # in the tail of a band above
            return r * (tmax + bmax) + row - (hr - t)
        if r > s and row < b:  # in the head of a band below
            return r * (tmax + bmax) + tmax + row
        raise AssertionError(f"row {g} is no peer's halo piece")

    above = [source(g) for g in range(starts[s] - top, starts[s])]
    below = [source(g) for g in range(starts[s + 1],
                                      starts[s + 1] + bottom)]
    return above, below


class _HaloRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, top, bottom, mesh, fill, dim, heights):
        hb = x.shape[dim]
        heights = heights or mesh.band_heights(hb)
        t, b = min(top, hb), min(bottom, hb)
        tmax, bmax = min(top, max(heights)), min(bottom, max(heights))
        piece = torch.cat([_pad_rows(x.narrow(dim, hb - t, t), dim, tmax),
                           _pad_rows(x.narrow(dim, 0, b), dim, bmax)], dim)
        pieces = _all_gather(piece, mesh)
        zero = torch.zeros_like(x.narrow(dim, 0, 1))
        src = torch.cat(pieces + [x.narrow(dim, 0, 1),
                                  x.narrow(dim, hb - 1, 1), zero], dim)
        above, below = (torch.tensor(i, dtype=torch.long, device=x.device)
                        for i in _halo_index(heights, top, bottom,
                                             mesh.spatial_rank, fill))
        out = torch.cat([src.index_select(dim, above), x,
                         src.index_select(dim, below)], dim)
        ctx.mesh, ctx.dim = mesh, dim
        ctx.sizes = (top, hb, bottom, t, b, tmax, bmax)
        ctx.src_shape = src.shape
        ctx.save_for_backward(above, below)
        if dim == 2 and x.dim() == 4 and x.is_contiguous(
                memory_format=torch.channels_last):
            out = out.contiguous(memory_format=torch.channels_last)
        return out

    @staticmethod
    def backward(ctx, g):
        above, below = ctx.saved_tensors
        mesh, dim = ctx.mesh, ctx.dim
        top, hb, bottom, t, b, tmax, bmax = ctx.sizes
        n = mesh.spatial_size * (tmax + bmax)
        gsrc = torch.zeros(ctx.src_shape, dtype=torch.float32,
                           device=g.device)
        gsrc.index_add_(dim, above, g.narrow(dim, 0, top).float())
        gsrc.index_add_(dim, below, g.narrow(dim, top + hb, bottom).float())
        # every peer's gradient of every piece, summed: this rank's own
        mine = _all_reduce(gsrc.narrow(dim, 0, n).contiguous(), mesh).narrow(
            dim, mesh.spatial_rank * (tmax + bmax), tmax + bmax)
        gx = g.narrow(dim, top, hb).float().clone()
        gx.narrow(dim, hb - t, t).add_(mine.narrow(dim, 0, t))
        gx.narrow(dim, 0, b).add_(mine.narrow(dim, tmax, b))
        gx.narrow(dim, 0, 1).add_(gsrc.narrow(dim, n, 1))
        gx.narrow(dim, hb - 1, 1).add_(gsrc.narrow(dim, n + 1, 1))
        return gx.to(g.dtype), None, None, None, None, None, None


def halo_rows(x, top: int, bottom: int, mesh, fill: str = "zero",
              dim: int = 2, heights: tuple = ()):
    """The band ``x`` with ``top`` rows above and ``bottom`` below along
    ``dim`` (2: NCHW, 1: NHWC), taken from the spatial peers of ``mesh``;
    outside the frame, zeros (``fill="zero"``) or the frame's edge row
    (``"edge"``). ``heights``: the peers' bands of ``x``'s map, by default
    those of the pyramid level where this rank holds ``x.shape[dim]`` rows
    (``DataMesh.band_heights``). Differentiable: a borrowed row's gradient
    is added to its owner's."""
    if fill not in FILLS:
        raise ValueError(f"unknown fill {fill!r}; expected one of {FILLS}")
    if top < 0 or bottom < 0:
        raise ValueError(f"halo of {top} and {bottom} rows")
    if top == bottom == 0:
        return x
    return _HaloRows.apply(x, top, bottom, mesh, fill, dim, tuple(heights))


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim):
        hb = x.shape[dim]
        heights = mesh.band_heights(hb)
        ctx.mesh, ctx.dim, ctx.hb = mesh, dim, hb
        ctx.start = mesh.band_start(hb)
        pieces = _all_gather(_pad_rows(x, dim, max(heights)), mesh)
        return torch.cat([p.narrow(dim, 0, h)
                          for p, h in zip(pieces, heights)], dim)

    @staticmethod
    def backward(ctx, g):
        total = _all_reduce(g.float().contiguous(), ctx.mesh)
        return (total.narrow(ctx.dim, ctx.start, ctx.hb).to(g.dtype), None,
                None)


def gather_rows(x, mesh, dim: int = 2):
    """The whole frame of the band ``x`` along ``dim``, the spatial peers'
    bands in order. Differentiable: the backward sums the peers'
    gradients and keeps this band's."""
    if not mesh.banded:
        return x
    return _GatherRows.apply(x, mesh, dim)

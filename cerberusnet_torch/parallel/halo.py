"""Halo exchanges of the spatial mesh axis (``train.num_spatial_devices``):
the rows a rank borrows from the ranks that hold the neighbouring bands of
an image, which GSPMD inserts for the reference.

A rank of a spatial mesh (``parallel/mesh.py``'s ``DataMesh``, S peers)
holds rows [s h, (s+1) h) of every map, h = H / S at that map's
resolution. An op that reads r rows across its output row (a 3x3
convolution at dilation r, a bilinear resize, a shifted difference) runs
on the band with r rows of halo on each side:

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
point-to-point exchange would. Gradients are summed in float32 and cast
once. An exchange that fails raises: there is no fallback.

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
def _halo_index(hb: int, top: int, bottom: int, s: int, n: int, fill: str):
    """(rows above, rows below) of band ``s`` of ``n`` bands of ``hb``
    rows, as indices into the source ``_HaloRows`` builds: each peer's
    piece (its last t and first b rows, t = min(top, hb), b = min(bottom,
    hb)) in spatial order, then the band's own first and last rows, then a
    row of zeros."""
    t, b = min(top, hb), min(bottom, hb)
    first, last, zero = n * (t + b), n * (t + b) + 1, n * (t + b) + 2
    frame = n * hb

    def source(g):
        if not 0 <= g < frame:
            if fill == "zero":
                return zero
            if g < 0 and s == 0:
                return first
            if g >= frame and s == n - 1:
                return last
            g = 0 if g < 0 else frame - 1
        r, row = divmod(g, hb)
        if r < s and row >= hb - t:  # in the tail of a band above
            return r * (t + b) + row - (hb - t)
        if r > s and row < b:  # in the head of a band below
            return r * (t + b) + t + row
        raise AssertionError(f"row {g} is no peer's halo piece")

    above = [source(g) for g in range(s * hb - top, s * hb)]
    below = [source(g) for g in range((s + 1) * hb, (s + 1) * hb + bottom)]
    return above, below


class _HaloRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, top, bottom, mesh, fill, dim):
        hb = x.shape[dim]
        t, b = min(top, hb), min(bottom, hb)
        s, n = mesh.spatial_rank, mesh.spatial_size
        pieces = _all_gather(torch.cat([x.narrow(dim, hb - t, t),
                                        x.narrow(dim, 0, b)], dim), mesh)
        zero = torch.zeros_like(x.narrow(dim, 0, 1))
        src = torch.cat(pieces + [x.narrow(dim, 0, 1),
                                  x.narrow(dim, hb - 1, 1), zero], dim)
        above, below = (torch.tensor(i, dtype=torch.long, device=x.device)
                        for i in _halo_index(hb, top, bottom, s, n, fill))
        out = torch.cat([src.index_select(dim, above), x,
                         src.index_select(dim, below)], dim)
        ctx.mesh, ctx.dim, ctx.sizes = mesh, dim, (top, hb, bottom, t, b)
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
        top, hb, bottom, t, b = ctx.sizes
        n = mesh.spatial_size * (t + b)
        gsrc = torch.zeros(ctx.src_shape, dtype=torch.float32,
                           device=g.device)
        gsrc.index_add_(dim, above, g.narrow(dim, 0, top).float())
        gsrc.index_add_(dim, below, g.narrow(dim, top + hb, bottom).float())
        # every peer's gradient of every piece, summed: this rank's own
        mine = _all_reduce(gsrc.narrow(dim, 0, n).contiguous(), mesh).narrow(
            dim, mesh.spatial_rank * (t + b), t + b)
        gx = g.narrow(dim, top, hb).float().clone()
        gx.narrow(dim, hb - t, t).add_(mine.narrow(dim, 0, t))
        gx.narrow(dim, 0, b).add_(mine.narrow(dim, t, b))
        gx.narrow(dim, 0, 1).add_(gsrc.narrow(dim, n, 1))
        gx.narrow(dim, hb - 1, 1).add_(gsrc.narrow(dim, n + 1, 1))
        return gx.to(g.dtype), None, None, None, None, None


def halo_rows(x, top: int, bottom: int, mesh, fill: str = "zero",
              dim: int = 2):
    """The band ``x`` with ``top`` rows above and ``bottom`` below along
    ``dim`` (2: NCHW, 1: NHWC), taken from the spatial peers of ``mesh``;
    outside the frame, zeros (``fill="zero"``) or the frame's edge row
    (``"edge"``). Differentiable: a borrowed row's gradient is added to
    its owner's."""
    if fill not in FILLS:
        raise ValueError(f"unknown fill {fill!r}; expected one of {FILLS}")
    if top < 0 or bottom < 0:
        raise ValueError(f"halo of {top} and {bottom} rows")
    if top == bottom == 0:
        return x
    return _HaloRows.apply(x, top, bottom, mesh, fill, dim)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim, ctx.hb = mesh, dim, x.shape[dim]
        return torch.cat(_all_gather(x, mesh), dim)

    @staticmethod
    def backward(ctx, g):
        mesh, hb = ctx.mesh, ctx.hb
        total = _all_reduce(g.float().contiguous(), mesh)
        return (total.narrow(ctx.dim, mesh.spatial_rank * hb, hb).to(g.dtype),
                None, None)


def gather_rows(x, mesh, dim: int = 2):
    """The whole frame of the band ``x`` along ``dim``, the spatial peers'
    bands in order. Differentiable: the backward sums the peers'
    gradients and keeps this band's."""
    if not mesh.banded:
        return x
    return _GatherRows.apply(x, mesh, dim)


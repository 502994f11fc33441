#!/usr/bin/env python3
"""How far each bf16 band resize of the spatial mesh axis stands from the
whole frame's resize cut to the band, on the CPU (ROADMAP C16).

    PYTHONPATH=. python3 scripts/band_resize_compare.py

Four gloo ranks, seen as tests/dp_ranks.py's meshes (``BF16_RESIZES``: 2 x 2
at 200 rows, 1 x 4 at 368), resize the bf16 frames of
``dp_ranks.bf16_resize_input`` between the cases' level extents, each at
the widths of ``BF16_RESIZE_WIDTHS``: ``upsample2x`` (and its phase form)
at x2, else ``upsample_to``. One JSON line a case: the share of each
rank's band elements that differ from ``models/common.py``'s whole-frame
``_resize`` (or ``upsample2x(impl="phase")``) cut to the band. A
measurement for the port's record, not a test
(tests/test_torch_spatial_offgrid.py holds the cases bit for bit).
"""

from __future__ import annotations

import json

import torch

from cerberusnet_torch.models.common import _resize, upsample2x
from tests import dp_ranks


def rank_shares():
    """{case: the share of this rank's band that differs}."""
    torch.set_num_threads(1)
    out = {}
    for h, (shape, pairs) in dp_ranks.BF16_RESIZES.items():
        mesh = dp_ranks.offgrid_mesh(shape, h)
        bands = dp_ranks.bf16_resize_bands(mesh, pairs)
        for key, band in bands.items():
            hs, hd, w, form = key.split()
            hs, hd, w = int(hs), int(hd), int(w)
            x = dp_ranks.bf16_resize_input(hs, w)
            _, ww = dp_ranks.bf16_resize_forms(hs, hd, w)[form]
            frame = (upsample2x(x, impl="phase") if form == "phase"
                     else _resize(x, (hd, ww)))[:, :, mesh.rows(hd)]
            out[f"{h} {key}"] = float(
                (torch.from_numpy(band) != frame.float()).float().mean())
    return out


def main():
    from cerberusnet_torch.parallel import launch

    ranks = launch(rank_shares, dp_ranks.SPATIAL_RANKS, timeout=600)
    for case in ranks[0]:
        h, hs, hd, w, form = case.split()
        print(json.dumps({"h": int(h), "source_rows": int(hs),
                          "target_rows": int(hd), "width": int(w),
                          "form": form,
                          "differ": [r[case] for r in ranks]}))


if __name__ == "__main__":
    main()

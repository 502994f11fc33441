"""Entry point: the default-width CerberusNet forward, ready to serve.

``entry()`` builds the joint model at the reference's default widths with
seeded random weights and returns ``(forward, example_inputs)``: the
forward takes (left, right, temporal) NHWC frames and returns the output
dict of ``CerberusNet.forward``. It runs on the GPU unless the caller asks
for ``device="cpu"``; with no CUDA device it raises rather than carry on on
the CPU.
"""

from __future__ import annotations

import torch

from cerberusnet_torch.models.cerberus import CerberusNet
from cerberusnet_torch.weights import init_params


def make_frames(seed: int, hw=(512, 1024), device="cuda",
                dtype: torch.dtype = torch.bfloat16):
    """A (left, right, temporal) triple of unit-normal (1, H, W, 3) frames,
    drawn on the CPU from ``seed`` so every device sees the same values."""
    gen = torch.Generator().manual_seed(seed)
    return tuple(
        torch.randn((1, *hw, 3), generator=gen).to(device=device,
                                                       dtype=dtype)
        for _ in range(3))


def entry(device="cuda", dtype: torch.dtype = torch.bfloat16, hw=(512, 1024),
          seed: int = 0, corr_impl: str | None = None):
    """Returns (forward, example_inputs) for the default-width model."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass device='cpu' to run the model on the CPU")
    model = CerberusNet(corr_impl=corr_impl, dtype=dtype)
    init_params(model, torch.Generator().manual_seed(seed))
    model = model.to(device).eval()

    @torch.inference_mode()
    def forward(left, right, temporal):
        return model(left, right, temporal)

    return forward, make_frames(seed, hw, device=device, dtype=dtype)

"""Evaluation and prediction: test-time augmentation, tiled inference and
the benchmarks' submission files."""

from cerberusnet_torch.eval.tiled import tiled_forward
from cerberusnet_torch.eval.tta import tta_forward

__all__ = ["tiled_forward", "tta_forward"]

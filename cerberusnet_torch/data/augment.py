"""Training augmentation on the device, port of
``cerberusnet_tpu/data/augment.py``, split into the random draws
(``draw``, from a ``torch.Generator`` on the host) and their application
to a batch of device tensors (``apply``), which the draws fix entirely.

* random crop of every spatial key (images, labels, flow, disparity and
  their valid masks): the values are translation-invariant;
* with ``scales``, one zoom factor s a batch from that discrete set: a
  crop of crop_hw / s, resized to crop_hw, the ground truth's values
  scaled (flow by (s_x, s_y), disparity by s_x), images rounded back to
  uint8;
* left-right flip of images, labels and flow (u negated), per sample,
  skipped when the batch has disparity ground truth (a rectified pair is
  not flip-invariant);
* contrast then brightness, per sample and image, clipped to the image's
  range (0-255 for uint8).

``draw`` takes the reference's choices in its order (scale, crop offsets,
flips, then per image key its contrast and brightness), but from torch's
generator, so the values differ from ``jax.random``'s; given the same
draws, ``apply`` computes ``augment_batch``'s result.
"""

from __future__ import annotations

import dataclasses

import torch

from cerberusnet_torch.data import encodings
from cerberusnet_torch.data.loader import IMAGE_KEYS

SPATIAL_KEYS = (*IMAGE_KEYS, "seg_labels", "flow_gt", "flow_valid",
                "disp_gt", "disp_valid")


@dataclasses.dataclass(frozen=True)
class AugmentConfig:
    crop_hw: tuple | None = None  # (H, W) random crop; None = off
    flip_lr_prob: float = 0.0
    brightness: float = 0.0  # max +- additive, in [0, 1] image units
    contrast: float = 0.0  # max +- multiplicative deviation
    scales: tuple = ()  # discrete zoom factors; needs crop_hw

    @property
    def enabled(self):
        return (self.crop_hw is not None or self.flip_lr_prob > 0
                or self.brightness > 0 or self.contrast > 0)

    def crop_size(self, scale_index, hw):
        """(sh, sw): the crop a batch of frames ``hw`` takes before any
        resize, for ``scales[scale_index]`` (None: no zoom)."""
        ch, cw = self.crop_hw
        if scale_index is None:
            return ch, cw
        s = self.scales[scale_index]
        return (min(max(int(round(ch / s)), 1), hw[0]),
                min(max(int(round(cw / s)), 1), hw[1]))


def draw(config: AugmentConfig, batch_size: int, hw, generator) -> dict:
    """The random choices of one batch of ``batch_size`` frames of size
    ``hw``: "scale_index" (with scales), "y0"/"x0" (B,) crop offsets,
    "flip" (B,) bool, "contrast"/"brightness" (3, B) per image key."""
    b, h, w = batch_size, *hw
    out = {}
    if config.crop_hw is not None:
        idx = None
        if config.scales:
            idx = int(torch.randint(len(config.scales), (),
                                    generator=generator))
            out["scale_index"] = idx
        sh, sw = config.crop_size(idx, hw)
        out["y0"] = torch.randint(max(h - sh, 0) + 1, (b,),
                                  generator=generator)
        out["x0"] = torch.randint(max(w - sw, 0) + 1, (b,),
                                  generator=generator)
    if config.flip_lr_prob > 0:
        out["flip"] = torch.rand(b, generator=generator) < config.flip_lr_prob
    for key, amount in (("contrast", config.contrast),
                        ("brightness", config.brightness)):
        if amount > 0:
            u = torch.rand(len(IMAGE_KEYS), b, generator=generator)
            out[key] = (2 * u - 1) * amount
    return out


def shard_draws(draws: dict, rows: slice) -> dict:
    """The draws of a global batch's ``rows`` (a data-parallel rank's
    slice): the per-sample ones sliced, the batch's scale kept."""
    out = {}
    for k, v in draws.items():
        if k in ("y0", "x0", "flip"):
            v = v[rows]
        elif k in ("contrast", "brightness"):
            v = v[:, rows]
        out[k] = v
    return out


def _crop(x, y0, x0, ch, cw):
    """Per-sample crops (B, ch, cw, ...) of x (B, H, W, ...) at the
    offsets (B,) on the host."""
    return torch.stack([x[i, int(y):int(y) + ch, int(xx):int(xx) + cw]
                        for i, (y, xx) in enumerate(zip(y0, x0))])


def _crop_resize(batch, y0, x0, sh, sw, ch, cw):
    """A (sh, sw) crop of every spatial key, resized to (ch, cw) with the
    ground truth's value scaling: the reference's scale branch."""
    out = dict(batch)
    for k in IMAGE_KEYS:
        if k in out:
            img = _crop(out[k], y0, x0, sh, sw).float()
            if (sh, sw) != (ch, cw):
                img = encodings.resize_bilinear(img, (ch, cw))
            if batch[k].dtype == torch.uint8:
                img = img.round().clamp(0, 255)
            out[k] = img.to(batch[k].dtype)
    if "seg_labels" in out:
        out["seg_labels"] = encodings.resize_labels(
            _crop(out["seg_labels"], y0, x0, sh, sw), (ch, cw))
    if "flow_gt" in out:
        valid = out.get("flow_valid", torch.ones_like(out["flow_gt"][..., 0]))
        out["flow_gt"], out["flow_valid"] = encodings.resize_flow(
            _crop(out["flow_gt"], y0, x0, sh, sw),
            _crop(valid, y0, x0, sh, sw), (ch, cw))
    if "disp_gt" in out:
        valid = out.get("disp_valid", (out["disp_gt"] > 0).float())
        out["disp_gt"], out["disp_valid"] = encodings.resize_disparity(
            _crop(out["disp_gt"], y0, x0, sh, sw),
            _crop(valid, y0, x0, sh, sw), (ch, cw))
    return out


def apply(batch: dict, draws: dict, config: AugmentConfig) -> dict:
    """``config``'s augmentation of a batch dict of (B, H, W, ...) tensors
    by ``draws`` (``draw``'s); keys it does not know pass through."""
    out = dict(batch)
    b = out["left"].shape[0]
    if config.crop_hw is not None:
        hw = tuple(out["left"].shape[1:3])
        y0, x0 = draws["y0"].tolist(), draws["x0"].tolist()
        if config.scales:
            sh, sw = config.crop_size(draws["scale_index"], hw)
            out = _crop_resize(out, y0, x0, sh, sw, *config.crop_hw)
        else:
            for k in SPATIAL_KEYS:
                if k in out:
                    out[k] = _crop(out[k], y0, x0, *config.crop_hw)

    if config.flip_lr_prob > 0 and "disp_gt" not in out:
        do = draws["flip"].to(out["left"].device)

        def maybe_flip(x):
            return torch.where(do.reshape((b,) + (1,) * (x.dim() - 1)),
                               x.flip(2), x)

        for k in (*IMAGE_KEYS, "seg_labels", "flow_valid"):
            if k in out:
                out[k] = maybe_flip(out[k])
        if "flow_gt" in out:
            f = maybe_flip(out["flow_gt"])
            u = torch.where(do.reshape(b, 1, 1), -f[..., 0], f[..., 0])
            out["flow_gt"] = torch.stack([u, f[..., 1]], dim=-1)

    if config.brightness > 0 or config.contrast > 0:
        for i, k in enumerate(IMAGE_KEYS):
            if k not in out:
                continue
            img = out[k].float()
            scale = 255.0 if batch[k].dtype == torch.uint8 else 1.0
            if config.contrast > 0:
                c = 1.0 + draws["contrast"][i].to(img.device).reshape(b, 1, 1, 1)
                mean = img.mean(dim=(1, 2, 3), keepdim=True)
                img = (img - mean) * c + mean
            if config.brightness > 0:
                db = draws["brightness"][i].to(img.device).reshape(b, 1, 1, 1)
                img = img + db * scale
            out[k] = img.clamp(0, scale).to(batch[k].dtype)
    return out

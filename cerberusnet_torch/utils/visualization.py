"""Visualisation, a copy of the numpy-only
``cerberusnet_tpu/utils/visualization.py`` (flow-to-colour HSV wheel,
disparity colour map, segmentation overlay, summary panel), and a PNG
writer and reader built on ``zlib`` and ``struct`` alone: the reference
writes its panels with ``cv2.imwrite``, and the port needs neither cv2 nor
PIL. These run on the host, on outputs already read from the device."""

from __future__ import annotations

import struct
import zlib

import numpy as np

# The standard Cityscapes 19-class palette (trainId order).
CITYSCAPES_PALETTE = np.array(
    [
        [128, 64, 128], [244, 35, 232], [70, 70, 70], [102, 102, 156],
        [190, 153, 153], [153, 153, 153], [250, 170, 30], [220, 220, 0],
        [107, 142, 35], [152, 251, 152], [70, 130, 180], [220, 20, 60],
        [255, 0, 0], [0, 0, 142], [0, 0, 70], [0, 60, 100],
        [0, 80, 100], [0, 0, 230], [119, 11, 32],
    ],
    np.uint8,
)


def flow_to_color(flow: np.ndarray, max_flow: float | None = None) -> np.ndarray:
    """(H, W, 2) flow -> (H, W, 3) uint8, standard HSV wheel encoding:
    hue = direction, saturation/value = magnitude."""
    flow = np.asarray(flow, np.float32)
    u, v = flow[..., 0], flow[..., 1]
    mag = np.sqrt(u * u + v * v)
    ang = np.arctan2(-v, -u) / np.pi  # [-1, 1]
    if max_flow is None:
        max_flow = max(float(mag.max()), 1e-6)
    norm = np.clip(mag / max_flow, 0, 1)

    h = (ang + 1.0) / 2.0  # [0, 1]
    s = np.ones_like(h)
    val = norm

    i = np.floor(h * 6.0).astype(int) % 6
    f = h * 6.0 - np.floor(h * 6.0)
    p = val * (1 - s)
    q = val * (1 - f * s)
    t = val * (1 - (1 - f) * s)
    r = np.choose(i, [val, q, p, p, t, val])
    g = np.choose(i, [t, val, val, q, p, p])
    b = np.choose(i, [p, p, t, val, val, q])
    return (np.stack([r, g, b], -1) * 255).astype(np.uint8)


def disparity_to_color(disp: np.ndarray, max_disp: float | None = None) -> np.ndarray:
    """(H, W) disparity -> (H, W, 3) uint8 heat colormap (near=red)."""
    disp = np.asarray(disp, np.float32)
    if disp.ndim == 3:
        disp = disp[..., 0]
    if max_disp is None:
        max_disp = max(float(disp.max()), 1e-6)
    x = np.clip(disp / max_disp, 0, 1)
    # simple jet-like ramp
    r = np.clip(1.5 - np.abs(4 * x - 3), 0, 1)
    g = np.clip(1.5 - np.abs(4 * x - 2), 0, 1)
    b = np.clip(1.5 - np.abs(4 * x - 1), 0, 1)
    return (np.stack([r, g, b], -1) * 255).astype(np.uint8)


def seg_to_color(labels: np.ndarray, palette: np.ndarray = CITYSCAPES_PALETTE):
    """(H, W) trainIds -> (H, W, 3) uint8; ignore (255) renders black."""
    labels = np.asarray(labels)
    out = np.zeros(labels.shape + (3,), np.uint8)
    valid = labels < len(palette)
    out[valid] = palette[labels[valid]]
    return out


def seg_overlay(image_u8: np.ndarray, labels: np.ndarray, alpha: float = 0.5):
    """Blend a seg color map over an RGB image."""
    color = seg_to_color(labels)
    return (
        np.asarray(image_u8, np.float32) * (1 - alpha)
        + color.astype(np.float32) * alpha
    ).astype(np.uint8)


def summary_panel(sample_outputs: dict) -> np.ndarray:
    """Stack available visualisations vertically into one panel image:
    expects optional keys image (H,W,3 u8), seg (H,W ids), flow (H,W,2),
    disp (H,W)."""
    rows = []
    img = sample_outputs.get("image")
    if img is not None:
        rows.append(np.asarray(img, np.uint8))
    if "seg" in sample_outputs:
        base = img if img is not None else np.zeros(
            sample_outputs["seg"].shape + (3,), np.uint8
        )
        rows.append(seg_overlay(base, sample_outputs["seg"]))
    if "flow" in sample_outputs:
        rows.append(flow_to_color(sample_outputs["flow"]))
    if "disp" in sample_outputs:
        rows.append(disparity_to_color(sample_outputs["disp"]))
    if not rows:
        raise ValueError("nothing to visualise")
    return np.concatenate(rows, axis=0)


# ---------------------------------------------------------------------- PNG

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png_u8(path: str, image: np.ndarray) -> str:
    """Writes an (H, W, 3) uint8 RGB image as an 8-bit PNG (every row
    filter 0, one IDAT chunk); returns ``path``."""
    image = np.ascontiguousarray(image, np.uint8)
    if image.ndim != 3 or image.shape[2] != 3:
        raise ValueError(f"expected an (H, W, 3) image, got {image.shape}")
    h, w, _ = image.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           image.reshape(h, w * 3)], axis=1)
    data = (_PNG_SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(data)
    return path


def read_png_u8(path: str) -> np.ndarray:
    """Reads a PNG that ``write_png_u8`` wrote (8-bit RGB, no interlace,
    filter 0 on every row) back into an (H, W, 3) uint8 array; raises on
    anything else."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_PNG_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    pos, header, idat = len(_PNG_SIGNATURE), None, b""
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"{path}: bad CRC in {kind!r}")
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat += body
        pos += 12 + n
    if header is None or header[2:] != (8, 2, 0, 0, 0):
        raise ValueError(f"{path}: not 8-bit RGB without interlace: {header}")
    w, h = header[:2]
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + w * 3)
    if rows[:, 0].any():
        raise ValueError(f"{path}: a row uses a filter other than 0")
    return rows[:, 1:].reshape(h, w, 3).copy()

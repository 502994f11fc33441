"""Visualisation, a copy of the numpy-only
``cerberusnet_tpu/utils/visualization.py`` (flow-to-colour HSV wheel,
disparity colour map, segmentation overlay, summary panel), and a PNG
codec built on ``zlib`` and ``struct`` alone (8- and 16-bit gray, gray +
alpha, RGB and RGBA; the reader takes every row filter): the reference
writes its panels with ``cv2.imwrite`` and reads what its native decoder
refuses with OpenCV, and the port needs neither cv2 nor PIL. These run on the host, on outputs already read from the device."""

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
# IHDR colour type by channel count, and back: gray, gray + alpha, RGB, RGBA
_COLOR_TYPES = {1: 0, 2: 4, 3: 2, 4: 6}
_CHANNELS = {v: k for k, v in _COLOR_TYPES.items()}


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(image: np.ndarray) -> bytes:
    """The 8- or 16-bit PNG file of an (H, W) or (H, W, C) uint8 or uint16
    image (C = 1, 2, 3 or 4: gray, gray + alpha, RGB, RGBA), every row
    filter 0 in one IDAT chunk."""
    image = np.asarray(image)
    if image.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"expected uint8 or uint16 samples, got {image.dtype}")
    if image.ndim == 2:
        image = image[..., None]
    if image.ndim != 3 or image.shape[2] not in _COLOR_TYPES:
        raise ValueError(f"expected an (H, W) or (H, W, 1-4) image, got "
                         f"{image.shape}")
    h, w, c = image.shape
    depth = 8 * image.dtype.itemsize
    samples = np.ascontiguousarray(image, image.dtype.newbyteorder(">"))
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           samples.view(np.uint8).reshape(h, -1)], axis=1)
    header = struct.pack(">IIBBBBB", w, h, depth, _COLOR_TYPES[c], 0, 0, 0)
    return (_PNG_SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _chunk(b"IEND", b""))


def write_png(path: str, image: np.ndarray) -> str:
    """Writes ``encode_png(image)`` to ``path``; returns ``path``."""
    data = encode_png(image)
    with open(path, "wb") as f:
        f.write(data)
    return path


def _unfilter(raw: bytes, h: int, rowbytes: int, bpp: int) -> np.ndarray:
    """Undoes the PNG row filters (0 none, 1 sub, 2 up, 3 average, 4 Paeth)
    of ``h`` rows of ``rowbytes`` bytes, ``bpp`` bytes a pixel."""
    out = np.empty((h, rowbytes), np.uint8)
    prior = np.zeros(rowbytes, np.uint8)
    stride = rowbytes + 1
    for y in range(h):
        kind = raw[y * stride]
        line = np.frombuffer(raw, np.uint8, rowbytes, y * stride + 1)
        if kind == 0:
            cur = line
        elif kind == 1:  # wraps mod 256 in uint8
            cur = np.cumsum(line.reshape(-1, bpp), axis=0,
                            dtype=np.uint8).reshape(-1)
        elif kind == 2:
            cur = line + prior
        elif kind in (3, 4):
            cur, up = bytearray(line.tobytes()), prior.tobytes()
            for i in range(rowbytes):
                a = cur[i - bpp] if i >= bpp else 0
                b = up[i]
                if kind == 3:
                    pred = (a + b) >> 1
                else:
                    c = up[i - bpp] if i >= bpp else 0
                    pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
                    pred = a if pa <= pb and pa <= pc else b if pb <= pc else c
                cur[i] = (cur[i] + pred) & 0xFF
            cur = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f"bad PNG row filter {kind}")
        out[y] = cur
        prior = out[y]
    return out


def read_png(path: str) -> np.ndarray:
    """Reads a non-interlaced 8- or 16-bit gray, gray + alpha, RGB or RGBA
    PNG, any row filters, into an (H, W) (one channel) or (H, W, C) uint8
    or uint16 array; raises ValueError on anything else (palette images,
    interlacing, other bit depths) and on a bad chunk CRC."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_PNG_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    pos, header, idat = len(_PNG_SIGNATURE), None, []
    while pos + 12 <= len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"{path}: bad CRC in {kind!r}")
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + n
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, color, _, _, interlace = header
    if depth not in (8, 16) or color not in _CHANNELS or interlace:
        raise ValueError(f"{path}: not an 8- or 16-bit gray/RGB(A) PNG "
                         f"without interlace: {header}")
    c = _CHANNELS[color]
    bpp = c * depth // 8
    raw = zlib.decompress(b"".join(idat))
    if len(raw) < h * (w * bpp + 1):
        raise ValueError(f"{path}: truncated image data")
    rows = _unfilter(raw, h, w * bpp, bpp)
    img = rows.view(">u2").astype(np.uint16) if depth == 16 else rows
    img = img.reshape(h, w, c)
    return img[..., 0] if c == 1 else img


def write_png_u8(path: str, image: np.ndarray) -> str:
    """Writes an (H, W, 3) uint8 RGB image as an 8-bit PNG; returns
    ``path``."""
    image = np.asarray(image)
    if image.ndim != 3 or image.shape[2] != 3:
        raise ValueError(f"expected an (H, W, 3) image, got {image.shape}")
    return write_png(path, image.astype(np.uint8))


def read_png_u8(path: str) -> np.ndarray:
    """Reads an 8-bit RGB PNG into an (H, W, 3) uint8 array; raises on any
    other kind."""
    img = read_png(path)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"{path}: not an 8-bit RGB PNG: {img.dtype} "
                         f"{img.shape}")
    return img

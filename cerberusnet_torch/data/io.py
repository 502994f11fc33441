"""Host-side image and ground-truth files, port of
``cerberusnet_tpu/data/io.py``.

PNGs decode through the native decoder (``data/native_io.py``); what it
refuses (palette, interlaced) or where it does not load, the port's own
zlib reader (``utils/visualization.read_png``) takes, in place of the
reference's OpenCV. Binary PPM and PGM files (P6 and P5 with a maxval of
255, FlyingChairs' frames) are read by ``read_pnm``, chosen by the
extension. Each reader takes an optional list ``decoded_by`` and appends
to it the decoder that ran, "native", "zlib" or "pnm". The writers are the
port's PNG writer (or ``write_pnm`` for a ``.ppm``/``.pgm`` name),
``.flo`` (Middlebury) and ``.pfm`` (FlyingThings3D) as the reference
writes them. All images come back in RGB order.
"""

from __future__ import annotations

import numpy as np

from cerberusnet_torch.data import native_io
from cerberusnet_torch.utils.visualization import read_png, write_png


PNM_EXTENSIONS = (".ppm", ".pgm")


def read_pnm(path: str) -> np.ndarray:
    """A binary PPM (P6, (H, W, 3) RGB) or PGM (P5, (H, W)) with a maxval
    of 255, as uint8. The header is the magic, the width, the height and
    the maxval, separated by whitespace and ``#`` comments, then one
    whitespace byte before the samples."""
    with open(path, "rb") as f:
        data = f.read()
    fields, pos = [], 0
    while len(fields) < 4:
        while pos < len(data) and data[pos:pos + 1].isspace():
            pos += 1
        if data[pos:pos + 1] == b"#":
            pos = data.find(b"\n", pos) + 1 or len(data)
            continue
        end = pos
        while end < len(data) and not data[end:end + 1].isspace():
            end += 1
        if end == pos:
            raise ValueError(f"{path}: truncated PNM header")
        fields.append(data[pos:end])
        pos = end
    magic, w, h, maxval = fields[0], *(int(x) for x in fields[1:])
    if magic not in (b"P6", b"P5") or maxval != 255:
        raise ValueError(f"{path}: not a binary 8-bit PPM or PGM "
                         f"({magic!r}, maxval {maxval})")
    shape = (h, w, 3) if magic == b"P6" else (h, w)
    pixels = np.frombuffer(data, np.uint8, int(np.prod(shape)), pos + 1)
    return pixels.reshape(shape).copy()


def write_pnm(path: str, img: np.ndarray) -> None:
    """An (H, W, 3) RGB image as a binary PPM, an (H, W) one as a PGM."""
    img = np.asarray(img, np.uint8)
    magic = b"P6" if img.ndim == 3 else b"P5"
    with open(path, "wb") as f:
        f.write(b"%s\n%d %d\n255\n" % (magic, img.shape[1], img.shape[0]))
        f.write(np.ascontiguousarray(img).tobytes())


def _decode(path: str, decoded_by: list | None) -> np.ndarray:
    img, how = None, "zlib"
    if str(path).lower().endswith(PNM_EXTENSIONS):
        img, how = read_pnm(path), "pnm"
    elif str(path).lower().endswith(".png") and native_io.available():
        try:
            img, how = native_io.decode_png(path), "native"
        except ValueError:
            pass  # a sub-format the native decoder refuses
    if img is None:
        img = read_png(path)
    if decoded_by is not None:
        decoded_by.append(how)
    return img


def read_image_u8(path: str, decoded_by: list | None = None) -> np.ndarray:
    """(H, W, 3) uint8 RGB: gray repeated, alpha dropped."""
    img = _decode(path, decoded_by)
    if img.dtype != np.uint8:
        raise ValueError(f"{path}: expected 8-bit samples, got {img.dtype}")
    if img.ndim == 2:
        return np.repeat(img[..., None], 3, axis=-1)
    if img.shape[-1] == 2:  # gray + alpha
        return np.repeat(img[..., :1], 3, axis=-1)
    return np.ascontiguousarray(img[..., :3])


def read_image_gray_u8(path: str, decoded_by: list | None = None) -> np.ndarray:
    """(H, W) uint8 single channel (e.g. Cityscapes labelIds)."""
    img = _decode(path, decoded_by)
    if img.dtype != np.uint8 or img.ndim != 2:
        raise ValueError(f"{path}: expected an 8-bit gray image, got "
                         f"{img.dtype} {img.shape}")
    return img


def read_png16(path: str, decoded_by: list | None = None) -> np.ndarray:
    """16-bit PNG: (H, W) or (H, W, 3) uint16, RGB channel order."""
    img = _decode(path, decoded_by)
    if img.dtype != np.uint16:
        raise ValueError(f"{path}: expected 16-bit samples, got {img.dtype}")
    return img


_FLO_MAGIC = 202021.25  # Middlebury sanity-check float ("PIEH" as LE f32)


def read_flo(path: str) -> np.ndarray:
    """Middlebury/Sintel .flo optical flow: (H, W, 2) float32, (u, v):
    little-endian f32 magic 202021.25, i32 width, i32 height, then H*W*2
    f32 row-major interleaved (u, v)."""
    with open(path, "rb") as f:
        magic = np.fromfile(f, "<f4", 1)
        if magic.size == 0 or magic[0] != _FLO_MAGIC:
            raise IOError(f"{path}: not a .flo file (magic {magic})")
        w, h = np.fromfile(f, "<i4", 2)
        data = np.fromfile(f, "<f4", int(w) * int(h) * 2)
    if data.size != w * h * 2:
        raise IOError(f"{path}: truncated .flo ({data.size} of {w * h * 2})")
    return data.reshape(int(h), int(w), 2)


def write_flo(path: str, flow: np.ndarray) -> None:
    flow = np.asarray(flow, "<f4")
    if flow.ndim != 3 or flow.shape[-1] != 2:
        raise ValueError(f"flow must be (H, W, 2), got {flow.shape}")
    h, w = flow.shape[:2]
    with open(path, "wb") as f:
        np.asarray([_FLO_MAGIC], "<f4").tofile(f)
        np.asarray([w, h], "<i4").tofile(f)
        np.ascontiguousarray(flow).tofile(f)


def read_pfm(path: str) -> np.ndarray:
    """Portable FloatMap: (H, W) or (H, W, 3) float32, rows top-down. The
    header is 'Pf' (gray) or 'PF' (colour), the width and height, and a
    scale whose sign is the byte order (negative: little-endian); the file
    stores its rows bottom-up."""
    with open(path, "rb") as f:
        header = f.readline().rstrip()
        if header not in (b"PF", b"Pf"):
            raise IOError(f"{path}: not a PFM file (header {header!r})")
        color = header == b"PF"
        dims = f.readline()
        while dims.startswith(b"#"):  # comment lines are legal
            dims = f.readline()
        w, h = (int(x) for x in dims.split())
        scale = float(f.readline().rstrip())
        dtype = "<f4" if scale < 0 else ">f4"
        data = np.fromfile(f, dtype, w * h * (3 if color else 1))
    shape = (h, w, 3) if color else (h, w)
    if data.size != int(np.prod(shape)):
        raise IOError(f"{path}: truncated PFM")
    return np.ascontiguousarray(data.reshape(shape)[::-1].astype(np.float32))


def write_pfm(path: str, img: np.ndarray) -> None:
    img = np.asarray(img, np.float32)
    if img.ndim == 3 and img.shape[-1] not in (1, 3):
        raise ValueError(f"PFM supports 1 or 3 channels, got {img.shape}")
    if img.ndim == 3 and img.shape[-1] == 1:
        img = img[..., 0]
    color = img.ndim == 3
    with open(path, "wb") as f:
        f.write(b"PF\n" if color else b"Pf\n")
        f.write(f"{img.shape[1]} {img.shape[0]}\n".encode())
        f.write(b"-1.0\n")  # little-endian
        np.ascontiguousarray(img[::-1].astype("<f4")).tofile(f)


def write_image_u8(path: str, img: np.ndarray) -> None:
    """An (H, W, 3) RGB or (H, W) gray image as an 8-bit PNG, or as a
    binary PPM or PGM where ``path`` ends so."""
    if str(path).lower().endswith(PNM_EXTENSIONS):
        write_pnm(path, img)
    else:
        write_png(path, np.asarray(img, np.uint8))


def write_png16(path: str, img: np.ndarray) -> None:
    """An (H, W) or (H, W, 3) (RGB) image as a 16-bit PNG."""
    write_png(path, np.asarray(img, np.uint16))

"""TensorBoard event files from ``struct`` and ``zlib`` alone, port of
``cerberusnet_tpu/utils/tblogger.py``: no tensorflow or tensorboard
package in the training path.

* TFRecord framing: <u64 len><u32 masked_crc32c(len)><payload>
  <u32 masked_crc32c(payload)>, CRC32C (Castagnoli, from a 256-entry
  table) masked as the TFRecord format asks (rotate 15, + 0xa282ead8).
* tensorflow.Event / Summary / Summary.Value / Summary.Image protobuf
  messages, encoded by hand (varints and tagged fields).

A scalar's record is the reference's byte for byte; an image's differs
only in its PNG, which the port's writer encodes (``encode_png``) where
the reference's uses OpenCV.
"""

from __future__ import annotations

import os
import socket
import struct
import time

import numpy as np

from cerberusnet_torch.utils.visualization import encode_png


def _crc_table():
    poly = 0x82F63B78
    table = []
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ (poly if c & 1 else 0)
        table.append(c)
    return tuple(table)


_CRC_TABLE = _crc_table()


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    table = _CRC_TABLE
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# -- protobuf fields ----------------------------------------------------------

def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _field_varint(field: int, value: int) -> bytes:
    return _varint(field << 3) + _varint(value & 0xFFFFFFFFFFFFFFFF)


def _field_bytes(field: int, payload: bytes) -> bytes:
    return _varint((field << 3) | 2) + _varint(len(payload)) + payload


def _field_double(field: int, value: float) -> bytes:
    return _varint((field << 3) | 1) + struct.pack("<d", value)


def _field_float(field: int, value: float) -> bytes:
    return _varint((field << 3) | 5) + struct.pack("<f", value)


def _encode_image(img_u8: np.ndarray) -> bytes:
    """Summary.Image of an (H, W, 3) uint8 RGB array, PNG-encoded."""
    img_u8 = np.ascontiguousarray(np.asarray(img_u8, np.uint8))
    h, w = img_u8.shape[:2]
    return (_field_varint(1, h) + _field_varint(2, w)
            + _field_varint(3, 3)  # colorspace RGB
            + _field_bytes(4, encode_png(img_u8)))


def _event(step: int, summary: bytes | None = None,
           file_version: str | None = None, wall_time: float | None = None):
    body = _field_double(1, time.time() if wall_time is None else wall_time)
    body += _field_varint(2, step)
    if file_version is not None:
        body += _field_bytes(3, file_version.encode())
    if summary is not None:
        body += _field_bytes(5, summary)
    return body


class TBLogger:
    """An append-only event file under ``logdir``:

    >>> tb = TBLogger(logdir)
    >>> tb.scalar("loss/total", 1.23, step=10)
    >>> tb.image("eval/panel", panel_u8, step=10)
    >>> tb.close()
    """

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        fname = "events.out.tfevents.%010d.%s.%d.v2" % (
            int(time.time()), socket.gethostname(), os.getpid())
        self.path = os.path.join(logdir, fname)
        self._f = open(self.path, "ab")
        self._record(_event(0, file_version="brain.Event:2"))

    def _record(self, payload: bytes):
        header = struct.pack("<Q", len(payload))
        self._f.write(header)
        self._f.write(struct.pack("<I", _masked_crc(header)))
        self._f.write(payload)
        self._f.write(struct.pack("<I", _masked_crc(payload)))

    def scalar(self, tag: str, value: float, step: int):
        val = _field_bytes(1, tag.encode()) + _field_float(2, float(value))
        self._record(_event(int(step), summary=_field_bytes(1, val)))

    def scalars(self, values: dict, step: int, prefix: str = ""):
        """A scalar for each numeric entry of ``values``; others are
        skipped."""
        for k, v in values.items():
            try:
                self.scalar(prefix + k, float(v), step)
            except (TypeError, ValueError):
                pass

    def image(self, tag: str, img_u8: np.ndarray, step: int):
        val = _field_bytes(1, tag.encode()) + _field_bytes(
            4, _encode_image(img_u8))
        self._record(_event(int(step), summary=_field_bytes(1, val)))

    def flush(self):
        self._f.flush()

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

"""A small PNG decoder and encoder on ``zlib`` and numpy.

The dataset's occupancy images are PNG files: the JAX package writes them
with ``matplotlib.pyplot.imsave(cmap="gray")`` (8-bit RGBA) and reads them
with ``matplotlib.pyplot.imread``.  The port reads and writes the same
files without matplotlib:

* :func:`read_png`: 8-bit, non-interlaced images of colour type 0 (grey),
  2 (RGB), 4 (grey + alpha) and 6 (RGBA), every filter type (none, sub, up,
  average, Paeth), as ``imread`` returns them: float32 ``value / 255``,
  (H, W) for grey, (H, W, 3) for RGB, (H, W, 4) for RGBA and for grey +
  alpha (grey repeated).
* :func:`write_png`: an 8-bit RGBA image;
  :func:`gray_rgba` gives the bytes ``imsave(cmap="gray")`` writes for an
  array (min-max scaled in the array's float type, then matplotlib's grey
  lookup table).
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}
# matplotlib's 256-entry grey lookup table as bytes.
_GRAY_LUT = (np.linspace(0.0, 1.0, 256) * 255).astype(np.uint8)


def _chunks(data: bytes):
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    pos = 8
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"PNG chunk {kind!r}: bad CRC")
        yield kind, body
        pos += 12 + n


def _unfilter(raw: bytes, h: int, w: int, bpp: int) -> np.ndarray:
    """The (h, w·bpp) bytes of the scanlines, their filters undone."""
    stride = w * bpp
    rows = np.frombuffer(raw, np.uint8).reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    for r in range(h):
        kind, line = rows[r, 0], rows[r, 1:].astype(np.int32)
        if kind == 0:
            cur = line
        elif kind == 2:
            cur = (line + prev) & 0xFF
        elif kind in (1, 3, 4):
            cur = np.zeros(stride, np.int32)
            for i in range(stride):
                a = cur[i - bpp] if i >= bpp else 0
                if kind == 1:
                    pred = a
                elif kind == 3:
                    pred = (a + prev[i]) >> 1
                else:
                    b = prev[i]
                    c = prev[i - bpp] if i >= bpp else 0
                    pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
                    pred = a if pa <= pb and pa <= pc else (
                        b if pb <= pc else c)
                cur[i] = (line[i] + pred) & 0xFF
        else:
            raise ValueError(f"PNG filter type {kind} does not exist")
        out[r] = cur
        prev = cur
    return out


def read_png(path) -> np.ndarray:
    """The image at ``path`` as float32 in [0, 1] (``value / 255``)."""
    with open(path, "rb") as fp:
        data = fp.read()
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, ctype, _, _, interlace = header
    if depth != 8 or ctype not in _CHANNELS or interlace:
        raise ValueError(f"{path}: only 8-bit, non-interlaced PNGs of colour "
                         f"type 0, 2, 4 or 6 are read; got depth {depth}, "
                         f"type {ctype}, interlace {interlace}")
    ch = _CHANNELS[ctype]
    px = _unfilter(zlib.decompress(b"".join(idat)), h, w, ch)
    px = px.reshape(h, w, ch)
    if ch == 1:
        px = px[..., 0]
    elif ch == 2:
        px = px[..., [0, 0, 0, 1]]
    return np.divide(px, 255, dtype=np.float32)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def write_png(path, rgba: np.ndarray) -> None:
    """Write (H, W, 4) uint8 ``rgba`` as an 8-bit RGBA PNG (filter none)."""
    rgba = np.ascontiguousarray(rgba, np.uint8)
    h, w, ch = rgba.shape
    if ch != 4:
        raise ValueError(f"write_png takes (H, W, 4) RGBA; got {rgba.shape}")
    raw = np.concatenate([np.zeros((h, 1), np.uint8),
                          rgba.reshape(h, 4 * w)], axis=1).tobytes()
    with open(path, "wb") as fp:
        fp.write(_SIGNATURE
                 + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 6, 0, 0,
                                               0))
                 + _chunk(b"IDAT", zlib.compress(raw, 6))
                 + _chunk(b"IEND", b""))


def gray_rgba(im: np.ndarray) -> np.ndarray:
    """The (H, W, 4) uint8 pixels ``imsave(cmap="gray")`` writes for the
    (H, W) array ``im``: scaled to [0, 1] between its min and max (0 where
    they are equal) in its float type, then binned into matplotlib's 256
    grey levels; alpha 255."""
    x = np.asarray(im)
    if not np.issubdtype(x.dtype, np.floating):
        x = x.astype(np.promote_types(x.dtype, np.float32))
    lo, hi = x.min(), x.max()
    v = np.zeros_like(x) if hi == lo else (x - lo) / (hi - lo)
    idx = v * x.dtype.type(256)
    idx[idx == 256] = 255
    g = _GRAY_LUT[np.clip(idx, 0, 255).astype(int)]
    return np.stack([g, g, g, np.full_like(g, 255)], axis=-1)

"""Image IO on the host: a zlib + NumPy PNG codec, PIL for the rest.

NumPy twin of `mulut_tpu.utils.imgio` (PIL-backed there).  `read_png` and
`write_png` cover 8-bit gray, gray + alpha, RGB and RGBA PNGs without
interlacing, which is every PNG this package reads or writes, so neither
the evaluation nor the data caches need PIL.  A decoded PNG holds the
pixel array PIL gives for the same file, and a PNG written here is the
file PIL writes for the array (the same bytes where both run the same
zlib).  `load_image` and `save_image` fall back to PIL (imported inside)
for any other file: a palette or 16-bit PNG, an interlaced one, a JPEG or
a BMP.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
#: PNG color type -> channels (0 gray, 2 RGB, 4 gray + alpha, 6 RGBA)
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}
_COLOR_TYPE = {c: t for t, c in _CHANNELS.items()}


def _chunks(data: bytes):
    """(type, payload) of every chunk after the signature."""
    pos = len(_SIGNATURE)
    while pos + 8 <= len(data):
        (n,) = struct.unpack(">I", data[pos: pos + 4])
        kind = data[pos + 4: pos + 8]
        yield kind, data[pos + 8: pos + 8 + n]
        pos += 12 + n
        if kind == b"IEND":
            return


def _paeth(a, b, c):
    """The Paeth predictor on int16 arrays (PNG spec 9.4)."""
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(raw: np.ndarray, h: int, w: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters (PNG spec 9.2) of a non-interlaced 8-bit
    image: `raw` holds h rows of one filter byte and w * bpp bytes;
    returns (h, w, bpp) uint8."""
    rows = raw.reshape(h, w * bpp + 1)
    kinds, lines = rows[:, 0], rows[:, 1:].reshape(h, w, bpp)
    if kinds.max(initial=0) > 4:
        raise ValueError(f"PNG: unknown filter type {kinds.max()}")
    if not kinds.any():
        return lines.copy()
    if kinds.max() <= 2:
        # none, sub (a running sum along the row, mod 256) and up
        out = np.zeros((h, w, bpp), np.uint8)
        prev = np.zeros((w, bpp), np.uint8)
        for y in range(h):
            line = lines[y]
            if kinds[y] == 1:
                line = np.cumsum(line, axis=0, dtype=np.uint8)
            elif kinds[y] == 2:
                line = line + prev
            out[y] = prev = line
        return out
    # average and Paeth read the reconstructed pixels to the left, above
    # and above-left: every pixel of one anti-diagonal depends only on the
    # two before it, so the image is rebuilt one anti-diagonal at a time
    pad = np.zeros((h + 1, w + 1, bpp), np.int16)
    kind_of = kinds.astype(np.int16)
    for d in range(h + w - 1):
        ys = np.arange(max(0, d - w + 1), min(h - 1, d) + 1)
        xs = d - ys
        a, b, c = pad[ys + 1, xs], pad[ys, xs + 1], pad[ys, xs]
        k = kind_of[ys][:, None]
        pred = np.where(k == 1, a, np.where(k == 2, b, np.where(
            k == 3, (a + b) >> 1, np.where(k == 4, _paeth(a, b, c), 0))))
        pad[ys + 1, xs + 1] = (lines[ys, xs] + pred) & 0xFF
    return pad[1:, 1:].astype(np.uint8)


def read_png(path: str):
    """An 8-bit non-interlaced gray / gray + alpha / RGB / RGBA PNG as the
    array PIL gives for it ((H, W) for gray, else (H, W, channels) uint8),
    or None for a file of any other kind (not a PNG, a palette, another
    bit depth, interlaced)."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_SIGNATURE):
        return None
    header, idat = None, []
    for kind, payload in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", payload[:13])
        elif kind == b"IDAT":
            idat.append(payload)
    if header is None:
        return None
    w, h, depth, color, _, _, interlace = header
    if depth != 8 or color not in _CHANNELS or interlace:
        return None
    c = _CHANNELS[color]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    px = _unfilter(raw[: h * (w * c + 1)], h, w, c)
    return px[:, :, 0] if c == 1 else px


def _chunk(kind: bytes, payload: bytes) -> bytes:
    crc = zlib.crc32(kind + payload) & 0xFFFFFFFF
    return struct.pack(">I", len(payload)) + kind + payload + struct.pack(
        ">I", crc)


def _filter_rows(rows: np.ndarray, bpp: int) -> np.ndarray:
    """(h, n) raw rows -> (h, n + 1) filtered rows, each under the filter
    PIL's encoder picks: the least sum of |byte| (a byte read as signed)
    over none, up, sub and Paeth, tried in that order, the first of equal
    sums kept (libpng's heuristic, as Pillow's ZipEncode applies it)."""
    prev = np.zeros_like(rows)
    prev[1:] = rows[:-1]
    left = np.zeros_like(rows)
    left[:, bpp:] = rows[:, :-bpp]
    up_left = np.zeros_like(rows)
    up_left[:, bpp:] = prev[:, :-bpp]
    paeth = _paeth(left.astype(np.int16), prev.astype(np.int16),
                   up_left.astype(np.int16)).astype(np.uint8)
    kinds = (0, 2, 1, 4)
    filtered = (rows, rows - prev, rows - left, rows - paeth)
    cost = np.stack([np.where(f < 128, f, 256 - f.astype(np.int64)).sum(1)
                     for f in filtered])
    pick = np.argmin(cost, axis=0)
    out = np.empty((rows.shape[0], rows.shape[1] + 1), np.uint8)
    for i, (kind, f) in enumerate(zip(kinds, filtered)):
        sel = pick == i
        out[sel, 0] = kind
        out[sel, 1:] = f[sel]
    return out


def write_png(path: str, img: np.ndarray) -> None:
    """Write a uint8 (H, W), (H, W, 2), (H, W, 3) or (H, W, 4) array as an
    8-bit PNG (gray, gray + alpha, RGB, RGBA), the file PIL's
    `Image.fromarray(img).save(path)` writes where both use the same
    zlib: PIL's row filters (`_filter_rows`), its deflate settings (level
    6, memLevel 9, the filtered strategy) and its IDAT chunks of
    max(65536, 4 W) bytes."""
    img = np.ascontiguousarray(np.asarray(img, dtype=np.uint8))
    c = 1 if img.ndim == 2 else img.shape[2]
    if img.ndim not in (2, 3) or c not in _COLOR_TYPE:
        raise ValueError(f"write_png: cannot write an array of shape "
                         f"{img.shape}")
    h, w = img.shape[:2]
    rows = _filter_rows(img.reshape(h, w * c), c)
    deflate = zlib.compressobj(-1, zlib.DEFLATED, 15, 9, zlib.Z_FILTERED)
    data = deflate.compress(rows.tobytes()) + deflate.flush()
    block = max(65536, 4 * w)
    header = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPE[c], 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_SIGNATURE + _chunk(b"IHDR", header))
        for i in range(0, len(data), block):
            f.write(_chunk(b"IDAT", data[i: i + block]))
        f.write(_chunk(b"IEND", b""))


def as_rgb(img: np.ndarray) -> np.ndarray:
    """A gray, gray + alpha, RGB or RGBA array as (H, W, 3) RGB, as PIL's
    `convert("RGB")` makes it: gray replicated, alpha dropped."""
    if img.ndim == 2:
        img = img[:, :, None]
    if img.shape[2] in (1, 2):
        return np.repeat(img[:, :, :1], 3, axis=2)
    return img[:, :, :3]


def load_image(path: str) -> np.ndarray:
    """Load an image as (H, W, 3) uint8; grayscale is replicated to 3
    channels and an alpha channel dropped (ref: sr/4_test_lut.py:268-277).
    The files `read_png` decodes need no PIL."""
    img = read_png(path)
    if img is None:
        from PIL import Image

        img = np.array(Image.open(path))
    if img.ndim == 2:
        img = np.stack([img, img, img], axis=2)
    if img.shape[2] == 4:
        img = img[:, :, :3]
    return img


def save_image(path: str, img: np.ndarray) -> None:
    """Save a uint8 image; a `.png` path through `write_png` (no PIL),
    any other format through PIL.  Makes the file's directory (a bare
    file name is written to the working directory)."""
    if os.path.dirname(path):
        os.makedirs(os.path.dirname(path), exist_ok=True)
    if path.lower().endswith(".png"):
        write_png(path, img)
        return
    from PIL import Image

    Image.fromarray(np.asarray(img, dtype=np.uint8)).save(path)

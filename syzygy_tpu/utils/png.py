"""PNG encoder/decoder on the standard library's ``zlib``.

Covers what the renderer writes and reads itself: 8-bit, non-interlaced
RGB and RGBA (frame dumps, viewer frames, goldens, the textures a GLB
export embeds). Other images a user's glTF may carry (JPEG, palette,
16-bit or interlaced PNG) go through Pillow, imported only then.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_COLOR_TYPES = {3: 2, 4: 6}  # channels -> PNG color type (RGB, RGBA)


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (
        struct.pack(">I", len(data))
        + tag
        + data
        + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
    )


def _to_u8(image) -> np.ndarray:
    arr = np.asarray(image)
    if arr.dtype != np.uint8:
        arr = (np.clip(arr, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    return arr


def encode_png(image, level: int = 6) -> bytes:
    """image: (H, W, 3|4) float [0,1] or uint8 -> PNG bytes.

    Every row uses the Sub filter (difference to the pixel on its left),
    which compresses smooth images well and decodes as a cumulative sum."""
    arr = _to_u8(image)
    if arr.ndim != 3 or arr.shape[2] not in _COLOR_TYPES:
        raise ValueError(f"expected (H, W, 3|4) image, got {arr.shape}")
    h, w, c = arr.shape
    rows = np.ascontiguousarray(arr).reshape(h, w * c)
    raw = np.empty((h, 1 + w * c), np.uint8)
    raw[:, 0] = 1  # Sub
    raw[:, 1 : 1 + c] = rows[:, :c]
    raw[:, 1 + c :] = rows[:, c:] - rows[:, :-c]  # uint8 arithmetic wraps
    header = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPES[c], 0, 0, 0)
    return (
        _SIGNATURE
        + _chunk(b"IHDR", header)
        + _chunk(b"IDAT", zlib.compress(raw.tobytes(), level))
        + _chunk(b"IEND", b"")
    )


class UnsupportedImage(ValueError):
    """An image this module's decoder does not handle."""


def _unfilter_rows(raw: np.ndarray, w: int, bpp: int) -> np.ndarray:
    # None (0), Sub (1) and Up (2) rows: one vectorised step per row
    h = raw.shape[0]
    out = np.empty((h, w * bpp), np.uint8)
    prev = np.zeros(w * bpp, np.uint8)
    for y in range(h):
        kind, line = raw[y, 0], raw[y, 1:]
        if kind == 0:
            out[y] = line
        elif kind == 1:
            out[y] = np.cumsum(
                line.reshape(w, bpp), axis=0, dtype=np.uint8
            ).reshape(w * bpp)
        else:
            out[y] = line + prev
        prev = out[y]
    return out


def _unfilter_wavefront(raw: np.ndarray, w: int, bpp: int) -> np.ndarray:
    """Any mix of the five filters, Average (3) and Paeth (4) included.

    Those two predict each pixel from its decoded left, upper and
    upper-left neighbours, so a row cannot be decoded in one step. All
    three neighbours of pixel (y, x) lie on the anti-diagonals y + x - 1
    and y + x - 2, so the image decodes one anti-diagonal at a time, each
    as a whole-array step. Storage is skewed, ``[y + x, y]``, to make each
    anti-diagonal contiguous."""
    h = raw.shape[0]
    kinds = raw[:, :1]
    ys, xs = np.divmod(np.arange(h * w), w)
    filt = np.zeros((h + w - 1, h, bpp), np.uint8)
    filt[ys + xs, ys] = raw[:, 1:].reshape(h * w, bpp)
    # two leading anti-diagonals and one leading row of zeros: the
    # neighbours outside the image; cells off the image stay zero as well
    out = np.zeros((h + w + 1, h + 1, bpp), np.uint8)
    for k in range(h + w - 1):
        y0, y1 = max(0, k - w + 1), min(h, k + 1)
        a = out[k + 1, y0 + 1 : y1 + 1].astype(np.int16)
        b = out[k + 1, y0:y1].astype(np.int16)
        c = out[k, y0:y1].astype(np.int16)
        kind = kinds[y0:y1]
        pa, pb = np.abs(b - c), np.abs(a - c)
        pc = np.abs(a + b - 2 * c)
        pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = np.where(kind == 3, (a + b) >> 1, pred)
        pred = np.where(kind == 2, b, pred)
        pred = np.where(kind == 1, a, pred)
        pred = np.where(kind == 0, 0, pred)
        out[k + 2, y0 + 1 : y1 + 1] = filt[k, y0:y1] + pred.astype(np.uint8)
    return out[ys + xs + 2, ys + 1].reshape(h, w * bpp)


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes (8-bit, non-interlaced RGB/RGBA) -> (H, W, 4) uint8 RGBA.

    Raises :class:`UnsupportedImage` for anything else."""
    if not data.startswith(_SIGNATURE):
        raise UnsupportedImage("not a PNG")
    pos = len(_SIGNATURE)
    header = None
    idat = []
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        tag = data[pos + 4 : pos + 8]
        body = data[pos + 8 : pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if header is None:
        raise UnsupportedImage("PNG without IHDR")
    w, h, depth, color_type, _, _, interlace = header
    channels = {v: k for k, v in _COLOR_TYPES.items()}.get(color_type)
    if depth != 8 or channels is None or interlace != 0:
        raise UnsupportedImage(
            f"PNG bit depth {depth}, color type {color_type}, interlace "
            f"{interlace}: only 8-bit non-interlaced RGB/RGBA is built in"
        )
    stride = w * channels
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    raw = raw[: h * (stride + 1)].reshape(h, stride + 1)
    kinds = raw[:, 0]
    if kinds.max(initial=0) > 4:
        raise UnsupportedImage(f"PNG filter type {kinds.max()}")
    if (kinds >= 3).any():
        out = _unfilter_wavefront(raw, w, channels)
    else:
        out = _unfilter_rows(raw, w, channels)
    img = out.reshape(h, w, channels)
    if channels == 3:
        img = np.concatenate([img, np.full((h, w, 1), 255, np.uint8)], axis=-1)
    return img


def decode_image(data: bytes) -> np.ndarray:
    """Image file bytes -> (H, W, 4) uint8 RGBA.

    PNGs this module handles decode here; anything else (JPEG, palette or
    16-bit PNG, ...) needs Pillow."""
    try:
        return decode_png(data)
    except UnsupportedImage as reason:
        try:
            from PIL import Image
        except ImportError:
            raise UnsupportedImage(
                f"{reason}; decoding this image needs Pillow, which is not "
                "installed (the built-in decoder reads 8-bit non-interlaced "
                "RGB/RGBA PNG only)"
            ) from None
        import io

        return np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"), np.uint8)


def write_png(path: str, image: np.ndarray) -> None:
    """image: (H, W, 3|4) float [0,1] or uint8."""
    with open(path, "wb") as f:
        f.write(encode_png(image))


def read_png(path: str) -> np.ndarray:
    """-> (H, W, 4) uint8 RGBA."""
    with open(path, "rb") as f:
        return decode_image(f.read())

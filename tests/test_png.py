"""The built-in PNG codec (utils/png.py): round trips, every PNG row
filter, and agreement with Pillow where Pillow is installed."""

import zlib

import numpy as np
import pytest

from syzygy_tpu.utils.png import (
    UnsupportedImage,
    decode_image,
    decode_png,
    encode_png,
    read_png,
    write_png,
)


def _image(h, w, c, seed=0):
    rng = np.random.default_rng(seed)
    smooth = np.linspace(0, 255, w, dtype=np.float32)[None, :, None]
    noise = rng.integers(0, 40, (h, w, c))
    return ((smooth + noise) % 256).astype(np.uint8)


@pytest.mark.parametrize("channels", [3, 4])
@pytest.mark.parametrize("shape", [(1, 1), (7, 13), (64, 96)])
def test_round_trip(channels, shape):
    img = _image(*shape, channels)
    out = decode_png(encode_png(img))
    assert out.shape == shape + (4,)
    np.testing.assert_array_equal(out[..., :channels], img)
    if channels == 3:
        assert (out[..., 3] == 255).all()


def test_float_input_quantizes_like_the_frame_path(tmp_path):
    img = np.random.default_rng(1).random((9, 11, 3), np.float32)
    path = str(tmp_path / "f.png")
    write_png(path, img)
    expect = (np.clip(img, 0, 1) * 255 + 0.5).astype(np.uint8)
    np.testing.assert_array_equal(read_png(path)[..., :3], expect)


def _filtered_png(img, kinds):
    """A PNG of ``img`` whose row ``y`` uses PNG filter ``kinds[y]``,
    filtered by the spec's formulas over the whole image at once."""
    h, w, c = img.shape
    cur = img.reshape(h, w * c).astype(np.int16)
    prev = np.concatenate([np.zeros((1, w * c), np.int16), cur[:-1]])
    left = np.pad(cur, ((0, 0), (c, 0)))[:, : w * c]
    up_left = np.pad(prev, ((0, 0), (c, 0)))[:, : w * c]
    p = left + prev - up_left
    pa, pb, pc = abs(p - left), abs(p - prev), abs(p - up_left)
    paeth = np.where(
        (pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, up_left)
    )
    preds = np.stack(
        [np.zeros_like(cur), left, prev, (left + prev) // 2, paeth]
    )
    pred = preds[np.asarray(kinds), np.arange(h)]
    raw = np.concatenate(
        [np.asarray(kinds, np.int16)[:, None], (cur - pred) % 256], axis=1
    ).astype(np.uint8)
    png = bytearray(encode_png(img))
    # swap the IDAT payload for the hand-filtered stream
    start = png.index(b"IDAT") - 4
    length = int.from_bytes(png[start:start + 4], "big")
    from syzygy_tpu.utils.png import _chunk

    png[start:start + 12 + length] = _chunk(
        b"IDAT", zlib.compress(raw.tobytes(), 1)
    )
    return bytes(png)


@pytest.mark.parametrize("kind", [0, 1, 2, 3, 4])
def test_every_row_filter_decodes(kind):
    """Hand-filter an image with one PNG filter type and decode it."""
    img = _image(5, 6, 3, seed=kind)
    png = _filtered_png(img, [kind] * img.shape[0])
    np.testing.assert_array_equal(decode_png(png)[..., :3], img)


@pytest.mark.parametrize("shape", [(1, 9, 4), (9, 1, 3), (23, 41, 3), (40, 17, 4)])
def test_mixed_row_filters_decode(shape):
    """Rows filtered with a random mix of all five filters, as adaptive
    encoders write them, including wide, tall and one-pixel images."""
    h, w, c = shape
    img = _image(h, w, c, seed=h * w)
    kinds = np.random.default_rng(h).integers(0, 5, h)
    out = decode_png(_filtered_png(img, kinds))
    np.testing.assert_array_equal(out[..., :c], img)


def test_paeth_texture_decodes_in_bulk():
    """A 2048x2048 RGBA texture with every row Paeth-filtered decodes
    with whole-array steps: a per-byte Python loop takes several seconds
    here; the bound leaves room for a loaded machine."""
    import time

    img = _image(2048, 2048, 4, seed=7)
    png = _filtered_png(img, [4] * 2048)
    start = time.perf_counter()
    out = decode_png(png)
    seconds = time.perf_counter() - start
    np.testing.assert_array_equal(out, img)
    assert seconds < 5.0, f"decoding took {seconds:.2f} s"


def test_unsupported_png_raises_clearly():
    img = _image(4, 4, 3)
    png = bytearray(encode_png(img))
    png[8 + 8 + 12] = 1  # IHDR interlace byte -> Adam7
    with pytest.raises(UnsupportedImage, match="interlace"):
        decode_png(bytes(png))
    with pytest.raises(UnsupportedImage):
        decode_png(b"not an image")


def test_pillow_agreement():
    """Pixel bytes agree with Pillow both ways: Pillow decodes our PNGs to
    the input, and our decoder reads Pillow's (adaptively filtered) PNGs
    to the same bytes Pillow decodes."""
    Image = pytest.importorskip("PIL.Image")
    import io

    for c, mode in ((3, "RGB"), (4, "RGBA")):
        img = _image(33, 47, c, seed=c)
        ours = Image.open(io.BytesIO(encode_png(img)))
        assert ours.mode == mode
        np.testing.assert_array_equal(np.asarray(ours), img)
        buf = io.BytesIO()
        Image.fromarray(img, mode).save(buf, format="PNG", optimize=True)
        pil_rgba = np.asarray(
            Image.open(io.BytesIO(buf.getvalue())).convert("RGBA")
        )
        np.testing.assert_array_equal(decode_image(buf.getvalue()), pil_rgba)


def test_golden_png_decodes_like_pillow():
    """The committed default-scene golden (written by Pillow) decodes to
    the same bytes with the built-in decoder."""
    import os

    Image = pytest.importorskip("PIL.Image")
    path = os.path.join(
        os.path.dirname(__file__), "goldens", "default_scene_256x128.png"
    )
    np.testing.assert_array_equal(
        read_png(path), np.asarray(Image.open(path).convert("RGBA"))
    )

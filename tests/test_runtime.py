"""Device-side frame quantization (runtime.fetch_frame_u8).

The viewer/app presentation hop fetches u8, not f32 (the reference
presents a B8G8R8A8_UNORM swapchain, editor/graphicscontext.cpp; the f32
fetch is 4x the bytes). The quantize must be bitwise-equal to the host path write_png/_png_bytes used
before it: (clip(x, 0, 1) * 255 + 0.5).astype(uint8).
"""

import numpy as np

from syzygy_tpu.runtime import fetch_frame_u8


def _host_quant(x):
    return (np.clip(x, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def test_fetch_frame_u8_bitwise_random():
    rng = np.random.default_rng(7)
    img = rng.random((64, 96, 3), np.float32)
    np.testing.assert_array_equal(fetch_frame_u8(img), _host_quant(img))


def test_fetch_frame_u8_bitwise_edges():
    # Out-of-range values, exact texel centers, halves (trunc-after-+0.5
    # round-half-up must agree), denormal-small, and the 255 endpoint.
    vals = np.array(
        [
            -1.0, -1e-8, 0.0, 1e-8,
            0.5 / 255.0, 1.0 / 255.0, 1.5 / 255.0,
            127.49999 / 255.0, 127.5 / 255.0, 127.50001 / 255.0,
            254.5 / 255.0, 1.0 - 1e-7, 1.0, 1.5, 2.0,
        ],
        np.float32,
    ).reshape(3, 5, 1)
    img = np.repeat(vals, 3, axis=-1)
    np.testing.assert_array_equal(fetch_frame_u8(img), _host_quant(img))

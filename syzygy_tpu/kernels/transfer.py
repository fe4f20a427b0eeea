"""Output transfer functions + the demo compute collection.

Ports of ``shaders/transfer/oetf_srgb.comp`` / ``oetf_pure_gamma.comp`` (the
in-place linear->nonlinear encode before present, ``editor/editor.cpp:303-340``)
and the generic compute demo shaders ``gradient_color.comp`` /
``matrix_color.comp`` that exercise the reference's ComputeCollectionPipeline
(``renderer/renderer.cpp:234-247``). Pure elementwise jnp — XLA fuses these
into neighbouring passes, which beats a hand-written kernel here.
"""

from __future__ import annotations

import jax.numpy as jnp


def oetf_srgb(linear: jnp.ndarray) -> jnp.ndarray:
    """Piecewise sRGB encode (``oetf_srgb.comp:9-19``)."""
    linear = jnp.clip(linear, 0.0, 1.0)
    lower = 12.92 * linear
    higher = 1.055 * jnp.power(jnp.maximum(linear, 1e-12), 1.0 / 2.4) - 0.055
    return jnp.where(linear <= 0.0031308, lower, higher)


def oetf_pure_gamma(linear: jnp.ndarray, gamma: float = 2.2) -> jnp.ndarray:
    """``oetf_pure_gamma.comp``: pow(1/gamma)."""
    return jnp.power(jnp.clip(linear, 0.0, 1.0), 1.0 / gamma)


def gradient_color(
    width: int,
    height: int,
    top_color=(1.0, 0.05, 0.05, 1.0),
    bottom_color=(0.05, 0.05, 1.0, 1.0),
) -> jnp.ndarray:
    """``gradient_color.comp``: vertical mix(top, bottom, uv.y)."""
    v = (jnp.arange(height, dtype=jnp.float32) + 0.5) / height
    top = jnp.asarray(top_color, jnp.float32)
    bottom = jnp.asarray(bottom_color, jnp.float32)
    rows = top[None, :] * (1.0 - v[:, None]) + bottom[None, :] * v[:, None]
    return jnp.broadcast_to(rows[:, None, :], (height, width, 4))


def boolean_push(width: int, height: int, rows) -> jnp.ndarray:
    """``booleanpush.comp``: 4x4 boolean grid, white/black blocks modulated
    by a (u, v, 0) tint. ``rows``: (4, 4) bool-ish."""
    rows = jnp.asarray(rows).astype(jnp.float32)
    u = (jnp.arange(width, dtype=jnp.float32) + 0.5) / width
    v = (jnp.arange(height, dtype=jnp.float32) + 0.5) / height
    iu = jnp.clip((u * 4).astype(jnp.int32), 0, 3)
    iv = jnp.clip((v * 4).astype(jnp.int32), 0, 3)
    on = rows[iv[:, None], iu[None, :]]  # (H, W)
    base = jnp.stack([on, on, on, jnp.ones_like(on)], axis=-1)
    tint = jnp.stack(
        [
            jnp.broadcast_to(u[None, :], (height, width)),
            jnp.broadcast_to(v[:, None], (height, width)),
            jnp.zeros((height, width), jnp.float32),
            jnp.ones((height, width), jnp.float32),
        ],
        axis=-1,
    )
    return base * tint


def sparse_push(
    width: int, height: int, top_color, bottom_color
) -> jnp.ndarray:
    """``sparse_push_constant.comp``: the gradient again, exercising the
    reference's sparse push-constant layout (same output as gradient_color —
    the layout trick has no JAX analog; the pass exists for ladder parity)."""
    return gradient_color(width, height, top_color, bottom_color)


def matrix_color(
    width: int, height: int, red: jnp.ndarray, green: jnp.ndarray, blue: jnp.ndarray
) -> jnp.ndarray:
    """``matrix_color.comp``: 4x4 push-constant color blocks."""
    u = (jnp.arange(width, dtype=jnp.float32) + 0.5) / width
    v = (jnp.arange(height, dtype=jnp.float32) + 0.5) / height
    iu = jnp.clip((u * 4).astype(jnp.int32), 0, 3)
    iv = jnp.clip((v * 4).astype(jnp.int32), 0, 3)
    red = jnp.asarray(red, jnp.float32)
    green = jnp.asarray(green, jnp.float32)
    blue = jnp.asarray(blue, jnp.float32)
    r = red[iv[:, None], iu[None, :]]
    g = green[iv[:, None], iu[None, :]]
    b = blue[iv[:, None], iu[None, :]]
    return jnp.stack([r, g, b, jnp.ones_like(r)], axis=-1)

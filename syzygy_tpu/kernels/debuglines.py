"""Debug line overlay: wireframe boxes drawn over the scene texture.

Port of ``DebugLineGraphicsPipeline`` (``renderer/pipelines.cpp:382-591``) +
``DebugLines`` (``renderer/pipelines/debuglines.hpp:21-62``) +
``shaders/debug/debugline.vert/.frag``: line-list geometry transformed by the
camera, drawn constant green with a depth test against the scene depth buffer
(the reference renders into the depth-tested scene target).

Software line raster: each line segment becomes a capsule test evaluated
over the pixel grid in jnp — segments are few (boxes for scene bounds /
instance AABBs), so a vectorized segments x pixels pass beats a scatter.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

LINE_COLOR = np.array([0.0, 1.0, 0.0], np.float32)  # debugline.vert:35

BOX_EDGES = np.array(
    [
        [0, 1], [1, 3], [3, 2], [2, 0],  # -z face (per AABB vertex order)
        [4, 5], [5, 7], [7, 6], [6, 4],  # +z face
        [0, 4], [1, 5], [2, 6], [3, 7],
    ],
    np.int32,
)


def box_segments(center, half_extent) -> np.ndarray:
    """12 edges of an axis-aligned box -> (12, 2, 3) world segments
    (``DebugLines::pushBox``)."""
    center = np.asarray(center, np.float32)
    half = np.asarray(half_extent, np.float32)
    signs = np.array(
        [[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)],
        np.float32,
    )
    verts = center[None, :] + half[None, :] * signs
    return verts[BOX_EDGES]


def draw_lines(
    color_image: jnp.ndarray,  # (H, W, 3)
    depth_buffer: jnp.ndarray,  # (H, W) reverse-Z scene depth
    segments: jnp.ndarray,  # (S, 2, 3) world-space endpoints
    segments_valid: jnp.ndarray,  # (S,) bool
    proj_view: jnp.ndarray,  # (4, 4)
    draw_extent: tuple[int, int],
    line_width: float = 1.0,  # DebugLines::lineWidth (debuglines.hpp:32)
) -> jnp.ndarray:
    """Composite depth-tested green lines over the color image."""
    h, w = depth_buffer.shape
    draw_w, draw_h = draw_extent

    seg = jnp.asarray(segments, jnp.float32)
    ones = jnp.ones((*seg.shape[:-1], 1), jnp.float32)
    clip = jnp.concatenate([seg, ones], axis=-1) @ proj_view.T  # (S, 2, 4)
    w_clip = clip[..., 3]
    visible = (w_clip > 1e-3).all(axis=-1) & jnp.asarray(segments_valid)
    w_safe = jnp.maximum(w_clip, 1e-3)
    ndc = clip[..., :3] / w_safe[..., None]
    sx = (ndc[..., 0] * 0.5 + 0.5) * draw_w  # (S, 2)
    sy = (ndc[..., 1] * 0.5 + 0.5) * draw_h
    sz = ndc[..., 2]

    px = jnp.arange(w, dtype=jnp.float32)[None, :] + 0.5  # (1, W)
    py = jnp.arange(h, dtype=jnp.float32)[:, None] + 0.5  # (H, 1)

    color = color_image
    half_width = 0.5 * line_width

    n_seg = seg.shape[0]
    overlay = jnp.zeros((h, w), bool)
    depth_best = jnp.zeros((h, w), jnp.float32)
    for s in range(n_seg):
        ax, ay, az = sx[s, 0], sy[s, 0], sz[s, 0]
        bx, by, bz = sx[s, 1], sy[s, 1], sz[s, 1]
        dx, dy = bx - ax, by - ay
        len_sq = jnp.maximum(dx * dx + dy * dy, 1e-8)
        t = jnp.clip(((px - ax) * dx + (py - ay) * dy) / len_sq, 0.0, 1.0)
        cx = ax + t * dx
        cy = ay + t * dy
        dist_sq = (px - cx) ** 2 + (py - cy) ** 2
        z = az + t * (bz - az)
        hit = (
            (dist_sq <= (half_width + 0.5) ** 2)
            & (z >= depth_buffer)  # reverse-Z GREATER_OR_EQUAL
            & (z <= 1.0)
            & visible[s]
        )
        overlay = overlay | hit
        depth_best = jnp.where(hit, jnp.maximum(depth_best, z), depth_best)

    return jnp.where(
        overlay[..., None], jnp.asarray(LINE_COLOR), color
    )

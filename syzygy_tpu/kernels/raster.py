"""Tile-binned software rasterizer: the replacement for Vulkan raster.

The reference rasterizes through the hardware pipeline
(``renderer/pipelines/deferred.cpp:503-713`` G-buffer pass,
``renderer/pipelines.cpp:593-806`` shadow depth pass). Here this becomes:

1. :func:`setup_triangles` (jnp, vectorized): clip-space vertices ->
   near-plane clipping (each triangle may split in two), screen-space
   barycentric linear forms, per-triangle screen bboxes, and the union
   bbox of every chunk of ``CHUNK`` consecutive slots (the coarse bin that
   lets a pixel tile skip whole chunks).
2. :func:`rasterize` (Pallas, Triton route): a visibility-buffer kernel
   with one program per pixel tile. Each program walks the chunks that
   overlap its tile in ascending order, and within a chunk the triangles
   whose bbox overlaps the tile, keeping depth / triangle id /
   barycentrics in registers and storing them once. Per triangle it
   evaluates the two barycentric linear forms over the tile and performs
   a reverse-Z GREATER_OR_EQUAL depth test (``deferred.cpp:549``).
3. :func:`rasterize_xla`: the same contract in plain ``jax.numpy``/``lax``
   (per-tile chunk lists, every tile run for the longest list). It is the
   reference the kernel is checked and timed against.

The raster emits only visibility (depth, clipped-triangle id, screen-space
barycentrics); attribute interpolation and texturing happen in the vectorized
resolve pass (``syzygy_tpu.kernels.resolve``), which keeps this kernel
payload-free.

Conventions: screen x right / y down, pixel centers at +0.5 (Vulkan), reverse-Z
(1 near, 0 far), front faces are CW on screen => positive doubled area
(``deferred.cpp:503-713``: CW front face, back-face cull).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from syzygy_tpu.kernels.common import cdiv, round_up

# Pixel tile of one kernel program, warps per program and triangles per
# chunk: powers of two (Triton block shapes), chosen by the tile sweep on
# the H100 recorded in PERF.md. Camera and shadow rasters measured alike,
# so both use these.
TILE_H = 16
TILE_W = 16
NUM_WARPS = 1
CHUNK = 128

W_CLIP_EPS = 1e-3  # near-plane clip guard in view-z units (w_clip = z_view)


class TriSetup(NamedTuple):
    """Screen-space triangle records after near-clip (capacity 2T, padded
    to a ``CHUNK`` multiple). Independent of the raster grid and origin."""

    coeffs: jnp.ndarray  # (T2, 16) f32, see the packing below
    orig_tri: jnp.ndarray  # (T2,) i32 -> original triangle id
    corner_bary: jnp.ndarray  # (T2, 3, 2) f32: corners' (b0,b1) wrt original
    corner_w: jnp.ndarray  # (T2, 3) f32 clip w of this (possibly clipped) tri
    # (T2 / CHUNK, 4) f32: union screen bbox [min_x, max_x, min_y, max_y]
    # of each chunk's triangles (+inf/-inf when the chunk holds none)
    chunk_bbox: jnp.ndarray


# coeffs packing (16 columns: Triton block dims are powers of two):
# 0:alpha0 1:beta0 2:gamma0 | 3:alpha1 4:beta1 5:gamma1 | 6:z2 7:dz0 8:dz1
# 9:valid (0/1) | 10:min_x 11:max_x 12:min_y 13:max_y (screen bbox in global
# pixels; +inf/-inf for invalid slots, so the kernel's bbox test also
# rejects them) | 14, 15: zero
_COEFF_WIDTH = 16
_BBOX = 10


def _out_vma(*arrays) -> frozenset:
    """Varying-manual-axes for pallas outputs: the union of the inputs'.

    Under ``jax.shard_map(check_vma=True)`` every output abstract value
    must state which mesh axes it varies over; ``pallas_call`` can't infer
    it, so we propagate the standard dataflow rule (outputs vary over every
    axis an input varies over) by hand. Outside shard_map this is the empty
    set, which ``ShapeDtypeStruct`` treats as unvarying."""
    vma: frozenset = frozenset()
    for a in arrays:
        v = getattr(jax.typeof(a), "vma", None)
        if v:
            vma |= frozenset(v)
    return vma


def _rotate_corners(arr, rot):
    """Rotate the corner axis (axis 1, size 3) of ``arr`` by per-row ``rot``.

    Selects between the three static rotations (elementwise) instead of a
    per-row ``take_along_axis`` gather; identical values."""
    r1 = jnp.concatenate([arr[:, 1:], arr[:, :1]], axis=1)
    r2 = jnp.concatenate([arr[:, 2:], arr[:, :2]], axis=1)
    expand = (slice(None),) + (None,) * (arr.ndim - 1)
    return jnp.where(
        (rot == 1)[expand], r1, jnp.where((rot == 2)[expand], r2, arr)
    )


def _setup_slots(
    tri_corner_clip: jnp.ndarray,  # (T, 3, 4) clip-space corners
    tri_valid: jnp.ndarray,  # (T,) bool
    width: int,
    height: int,
    cull_keep_sign: int,
    depth_bias_constant: float = 0.0,
    depth_bias_slope: float = 0.0,
):
    """Per-slot screen records: near-clip fan split, projection, affine
    barycentric/depth coefficients and screen bboxes.

    Everything here depends only on the triangles and the viewport, not on
    which row block of the frame a device rasters, so under image-space
    sharding it can be computed on a triangle SLICE per device and rejoined
    with an ``all_gather``.

    Returns ``(cols, all_bary, w_all)``: ``cols`` is (2T, 14) f32 packing
    [alpha0, beta0, gamma0, alpha1, beta1, gamma1, z2c, dz0, dz1, valid,
    bb_min_x, bb_max_x, bb_min_y, bb_max_y] in global pixel coordinates;
    slot t is the clip fan's first triangle of input t, slot T+t the
    second."""
    w = tri_corner_clip[..., 3]  # (T, 3)
    inside = w >= W_CLIP_EPS  # (T, 3)
    n_in = inside.sum(axis=-1)  # (T,)

    # Canonical rotation: n_in==1 -> inside vertex first; n_in==2 -> outside
    # vertex first; else identity.
    rot_one = jnp.argmax(inside, axis=-1).astype(jnp.int32)
    rot_two = jnp.argmin(inside, axis=-1).astype(jnp.int32)
    rot = jnp.where(n_in == 1, rot_one, jnp.where(n_in == 2, rot_two, 0))

    v = _rotate_corners(tri_corner_clip, rot)  # (T, 3, 4)
    # original-triangle barycentric coords of the 3 original corners, rotated
    eye_bary = jnp.array([[1.0, 0.0], [0.0, 1.0], [0.0, 0.0]], jnp.float32)
    vb = _rotate_corners(
        jnp.broadcast_to(eye_bary[None], (rot.shape[0], 3, 2)), rot
    )  # (T, 3, 2)

    v0, v1, v2 = v[:, 0], v[:, 1], v[:, 2]
    b0c, b1c, b2c = vb[:, 0], vb[:, 1], vb[:, 2]

    def lerp_to_plane(pa, pb, ba, bb):
        t = (W_CLIP_EPS - pa[..., 3]) / jnp.where(
            jnp.abs(pb[..., 3] - pa[..., 3]) < 1e-12,
            1e-12,
            pb[..., 3] - pa[..., 3],
        )
        t = jnp.clip(t, 0.0, 1.0)[..., None]
        return pa + t * (pb - pa), ba + t[..., 0:1] * (bb - ba)

    i01, b01 = lerp_to_plane(v0, v1, b0c, b1c)
    i02, b02 = lerp_to_plane(v0, v2, b0c, b2c)
    i20, b20 = lerp_to_plane(v2, v0, b2c, b0c)

    # Case n_in==3: A=(v0,v1,v2); n_in==1: A=(v0, i01, i02);
    # n_in==2 (v0 outside): A=(i01, v1, v2), B=(i01, v2, i20)
    def case_select(three, one, two):
        return jnp.where(
            (n_in == 3)[:, None, None],
            three,
            jnp.where((n_in == 1)[:, None, None], one, two),
        )

    tri_a = case_select(
        jnp.stack([v0, v1, v2], 1),
        jnp.stack([v0, i01, i02], 1),
        jnp.stack([i01, v1, v2], 1),
    )
    bary_a = case_select(
        jnp.stack([b0c, b1c, b2c], 1),
        jnp.stack([b0c, b01, b02], 1),
        jnp.stack([b01, b1c, b2c], 1),
    )
    tri_b = jnp.stack([i01, v2, i20], 1)
    bary_b = jnp.stack([b01, b2c, b20], 1)

    valid_in = tri_valid & (n_in > 0)
    valid_a = valid_in
    valid_b = tri_valid & (n_in == 2)

    all_tris = jnp.concatenate([tri_a, tri_b], axis=0)  # (2T, 3, 4)
    all_bary = jnp.concatenate([bary_a, bary_b], axis=0)  # (2T, 3, 2)
    all_valid = jnp.concatenate([valid_a, valid_b], axis=0)  # (2T,)

    # Project to screen
    w_all = jnp.maximum(all_tris[..., 3], W_CLIP_EPS * 0.5)
    ndc = all_tris[..., :3] / w_all[..., None]
    sx = (ndc[..., 0] * 0.5 + 0.5) * width  # (2T, 3)
    sy = (ndc[..., 1] * 0.5 + 0.5) * height
    sz = ndc[..., 2]

    x0, x1, x2 = sx[:, 0], sx[:, 1], sx[:, 2]
    y0, y1, y2 = sy[:, 0], sy[:, 1], sy[:, 2]
    area2 = (x1 - x0) * (y2 - y0) - (y1 - y0) * (x2 - x0)

    if cull_keep_sign > 0:
        facing = area2 > 0
    elif cull_keep_sign < 0:
        facing = area2 < 0
    else:
        facing = jnp.abs(area2) > 0
    all_valid = all_valid & facing & (jnp.abs(area2) > 1e-12)

    inv = jnp.where(jnp.abs(area2) < 1e-12, 0.0, 1.0 / area2)
    # b0 from edge v1->v2, b1 from edge v2->v0 (normalized by signed area)
    beta0 = -(y2 - y1) * inv
    gamma0 = (x2 - x1) * inv
    alpha0 = ((y2 - y1) * x1 - (x2 - x1) * y1) * inv
    beta1 = -(y0 - y2) * inv
    gamma1 = (x0 - x2) * inv
    alpha1 = ((y0 - y2) * x2 - (x0 - x2) * y2) * inv
    z2c = sz[:, 2]
    dz0 = sz[:, 0] - sz[:, 2]
    dz1 = sz[:, 1] - sz[:, 2]

    if depth_bias_constant != 0.0 or depth_bias_slope != 0.0:
        # z(px, py) is affine: dz/dx = dz0*beta0 + dz1*beta1, dz/dy likewise.
        slope_m = jnp.maximum(
            jnp.abs(dz0 * beta0 + dz1 * beta1),
            jnp.abs(dz0 * gamma0 + dz1 * gamma1),
        )
        z2c = z2c + (
            depth_bias_constant * jnp.float32(2.0**-23)
            + depth_bias_slope * slope_m
        )

    # screen bboxes (invalid slots get an empty +inf/-inf box)
    bb_min_x = jnp.where(all_valid, jnp.min(sx, axis=1), jnp.inf)
    bb_max_x = jnp.where(all_valid, jnp.max(sx, axis=1), -jnp.inf)
    bb_min_y = jnp.where(all_valid, jnp.min(sy, axis=1), jnp.inf)
    bb_max_y = jnp.where(all_valid, jnp.max(sy, axis=1), -jnp.inf)

    cols = jnp.stack(
        [
            alpha0, beta0, gamma0, alpha1, beta1, gamma1,
            z2c, dz0, dz1, all_valid.astype(jnp.float32),
            bb_min_x, bb_max_x, bb_min_y, bb_max_y,
        ],
        axis=-1,
    )
    return cols, all_bary, w_all




def _finish_setup(
    cols: jnp.ndarray,  # (2T, 14) from _setup_slots
    all_bary: jnp.ndarray,  # (2T, 3, 2)
    w_all: jnp.ndarray,  # (2T, 3)
) -> TriSetup:
    """Pad the slot records to a ``CHUNK`` multiple and bin them: the
    16-column coefficient rows plus each chunk's union screen bbox. Pad
    slots are invalid with an empty bbox."""
    t2 = cols.shape[0]
    t2_pad = round_up(max(t2, 1), CHUNK)
    pad = t2_pad - t2
    n_t = t2 // 2
    empty_bbox = jnp.array([jnp.inf, -jnp.inf, jnp.inf, -jnp.inf], jnp.float32)
    pad_rows = jnp.concatenate(
        [
            jnp.zeros((pad, _BBOX), jnp.float32),
            jnp.broadcast_to(empty_bbox, (pad, 4)),
        ],
        axis=1,
    )
    coeffs = jnp.concatenate([cols, pad_rows], axis=0)
    coeffs = jnp.concatenate(
        [coeffs, jnp.zeros((t2_pad, _COEFF_WIDTH - coeffs.shape[1]), jnp.float32)],
        axis=1,
    )
    bbox = coeffs[:, _BBOX:_BBOX + 4].reshape(t2_pad // CHUNK, CHUNK, 4)
    chunk_bbox = jnp.stack(
        [
            bbox[..., 0].min(axis=1),
            bbox[..., 1].max(axis=1),
            bbox[..., 2].min(axis=1),
            bbox[..., 3].max(axis=1),
        ],
        axis=-1,
    )
    return TriSetup(
        coeffs=coeffs,
        orig_tri=jnp.concatenate(
            [
                jnp.arange(n_t, dtype=jnp.int32),
                jnp.arange(n_t, dtype=jnp.int32),
                jnp.zeros(pad, jnp.int32),
            ]
        ),
        corner_bary=jnp.concatenate(
            [all_bary, jnp.zeros((pad, 3, 2), jnp.float32)], axis=0
        ),
        corner_w=jnp.concatenate(
            [w_all, jnp.ones((pad, 3), jnp.float32)], axis=0
        ),
        chunk_bbox=chunk_bbox,
    )


def setup_triangles(
    clip: jnp.ndarray,  # (V, 4) clip-space positions
    triangles: jnp.ndarray,  # (T, 3) int32
    tri_valid: jnp.ndarray,  # (T,) bool
    width: int,
    height: int,
    cull_keep_sign: int,  # +1 keep CW/front (gbuffer), -1 keep CCW (shadow), 0 none
    corner_clip: jnp.ndarray | None = None,  # (T, 3, 4) pre-gathered corners
    depth_bias_constant: float = 0.0,
    depth_bias_slope: float = 0.0,
    shard_axis: str | None = None,
) -> TriSetup:
    """Vectorized triangle setup with near-plane clipping.

    Replaces the fixed-function clipper + triangle setup. Each input triangle
    yields two slots (slot t and slot T+t); crossing triangles split into a
    fan of <= 2, others leave slot 2 invalid. ``width``/``height`` define
    the viewport (NDC -> pixel mapping, the reference's sceneSubregion
    extent). The result does not depend on the raster grid: records are in
    global pixel coordinates and :func:`rasterize` bins them per tile.

    ``shard_axis`` (inside shard_map only): partition the O(T) slot math
    (corner gather, clip fan, projection, coefficient build) across the
    named mesh axis and rejoin via ``all_gather``, so image-space sharding
    does not replicate the triangle setup on every device. BITWISE-identical
    to the unsharded setup (slot order preserved; elementwise math on row
    slices). Requires the device count to divide T (pack_geometry's chunk
    padding guarantees it for power-of-two meshes; otherwise the setup
    stays replicated).

    ``corner_clip`` lets callers that run the setup repeatedly (the shadow
    pass: one raster per light) supply per-triangle corner positions
    directly and skip the (T, 3)-row vertex gather — e.g. gather WORLD
    corners once and transform by each light's projView (``clip`` is then
    ignored and may be None).

    ``depth_bias_constant``/``depth_bias_slope`` reproduce
    ``vkCmdSetDepthBias(cmd, constant, 0, slope)`` as recorded by the
    reference's shadow depth pass (``renderer/pipelines.cpp:716``,
    ``shadowpass.hpp:26-27``): fragment depth gets ``constant * r +
    slope * m`` added, with r = 2^-23 (D32_SFLOAT minimum resolvable
    difference at z < 1) and m = max(|dz/dx|, |dz/dy|) per triangle. The
    offset is constant within a triangle, so it folds into the affine z
    coefficients; statically zero bias (the reference's default) leaves the
    setup bitwise unchanged.
    """
    if shard_axis is not None and (
        jax.lax.axis_size(shard_axis) == 1
        or triangles.shape[0] % jax.lax.axis_size(shard_axis) != 0
    ):
        # axis size 1: "sharding" would be an identity slice + all_gather
        # + reorder, pure full-table copies; a device count that does not
        # divide T keeps the replicated setup (correct, just unsharded)
        shard_axis = None
    if shard_axis is not None:
        # each device computes the slot records for a T/n_dev triangle
        # slice and an all_gather rejoins them. Slot layout stays canonical
        # ([all A slots, all B slots] in global triangle order) so raster
        # results, including last-wins depth ties, are IDENTICAL to the
        # unsharded setup.
        n_dev = jax.lax.axis_size(shard_axis)
        my = jax.lax.axis_index(shard_axis)
        n_t = triangles.shape[0]
        t_loc = n_t // n_dev
        start = my * t_loc
        val_l = jax.lax.dynamic_slice_in_dim(tri_valid, start, t_loc)
        if corner_clip is None:
            tri_l = jax.lax.dynamic_slice_in_dim(triangles, start, t_loc)
            corners_l = clip[tri_l]
        else:
            corners_l = jax.lax.dynamic_slice_in_dim(
                corner_clip, start, t_loc
            )
        cols_l, bary_l, w_l = _setup_slots(
            corners_l, val_l, width, height, cull_keep_sign,
            depth_bias_constant, depth_bias_slope,
        )

        def rejoin(x):
            # (n_dev, 2*t_loc, ...) -> canonical (2T, ...):
            # all A slots in global order, then all B slots
            g = jax.lax.all_gather(x, shard_axis)
            a = g[:, :t_loc].reshape((n_t,) + x.shape[1:])
            b = g[:, t_loc:].reshape((n_t,) + x.shape[1:])
            return jnp.concatenate([a, b], axis=0)

        cols, all_bary, w_all = (
            rejoin(cols_l), rejoin(bary_l), rejoin(w_l)
        )
    else:
        tri_corner_clip = (
            clip[triangles] if corner_clip is None else corner_clip
        )
        cols, all_bary, w_all = _setup_slots(
            tri_corner_clip, tri_valid, width, height, cull_keep_sign,
            depth_bias_constant, depth_bias_slope,
        )
    return _finish_setup(cols, all_bary, w_all)


class VisibilityBuffer(NamedTuple):
    depth: jnp.ndarray  # (H, W) f32, reverse-Z, 0 = background
    tri: jnp.ndarray  # (H, W) i32 clipped-triangle id, -1 = background
    b0: jnp.ndarray  # (H, W) f32 screen-space barycentric
    b1: jnp.ndarray  # (H, W) f32


def _raster_kernel(
    coeffs_ref,  # (T2, 16) f32, whole array in device memory
    chunk_bbox_ref,  # (T2 / CHUNK, 4) f32
    origin_ref,  # (2,) i32: the target's global (oy, ox) pixel origin
    *out_refs,  # depth[, tri, b0, b1]: this program's (TILE_H, TILE_W) block
    n_chunks: int,
    depth_only: bool,
):
    """One pixel tile: walk every chunk whose bbox overlaps the tile, then
    every triangle of the chunk whose bbox overlaps the tile, in ascending
    slot order, with the serial reverse-Z ``z >= current`` test (the later
    triangle wins equal-depth ties). Pixel coordinates are GLOBAL (local +
    origin: exact f32 integer adds), so a sharded row block evaluates
    bitwise the arithmetic of the single-device frame."""
    x0 = (pl.program_id(1) * TILE_W + origin_ref[1]).astype(jnp.float32)
    y0 = (pl.program_id(0) * TILE_H + origin_ref[0]).astype(jnp.float32)
    x1 = x0 + TILE_W
    y1 = y0 + TILE_H
    col = jax.lax.broadcasted_iota(jnp.int32, (TILE_H, TILE_W), 1)
    row = jax.lax.broadcasted_iota(jnp.int32, (TILE_H, TILE_W), 0)
    px = x0 + col.astype(jnp.float32) + 0.5
    py = y0 + row.astype(jnp.float32) + 0.5

    def overlaps(ref, i, c0):
        # bbox [min_x, max_x, min_y, max_y] at columns c0.. vs the tile's
        # pixel square [x0, x1) x [y0, y1); +inf/-inf boxes never overlap
        return (
            (ref[i, c0] < x1)
            & (ref[i, c0 + 1] >= x0)
            & (ref[i, c0 + 2] < y1)
            & (ref[i, c0 + 3] >= y0)
        )

    def shade(t, carry):
        bb0 = coeffs_ref[t, 0] + coeffs_ref[t, 1] * px + coeffs_ref[t, 2] * py
        bb1 = coeffs_ref[t, 3] + coeffs_ref[t, 4] * px + coeffs_ref[t, 5] * py
        bb2 = 1.0 - bb0 - bb1
        z = coeffs_ref[t, 6] + coeffs_ref[t, 7] * bb0 + coeffs_ref[t, 8] * bb1
        current = carry[0]
        hit = (
            (bb0 >= 0.0)
            & (bb1 >= 0.0)
            & (bb2 >= 0.0)
            & (z >= current)
            & (z <= 1.0)
            & (z >= 0.0)
        )
        depth = jnp.where(hit, z, current)
        if depth_only:
            return (depth,)
        _, tri, b0, b1 = carry
        return (
            depth,
            jnp.where(hit, t, tri),
            jnp.where(hit, bb0, b0),
            jnp.where(hit, bb1, b1),
        )

    def triangle(t, carry):
        return jax.lax.cond(
            overlaps(coeffs_ref, t, _BBOX),
            functools.partial(shade, t),
            lambda c: c,
            carry,
        )

    def chunk(c, carry):
        chunk_size = coeffs_ref.shape[0] // n_chunks
        return jax.lax.cond(
            overlaps(chunk_bbox_ref, c, 0),
            lambda cr: jax.lax.fori_loop(
                c * chunk_size, (c + 1) * chunk_size, triangle, cr
            ),
            lambda cr: cr,
            carry,
        )

    zeros = jnp.zeros((TILE_H, TILE_W), jnp.float32)
    init = (zeros,) if depth_only else (
        zeros, jnp.full((TILE_H, TILE_W), -1, jnp.int32), zeros, zeros
    )
    out = jax.lax.fori_loop(0, n_chunks, chunk, init)
    for ref, value in zip(out_refs, out):
        ref[...] = value


def _pallas_raster(
    coeffs, chunk_bbox, origin, *, tiles_y, tiles_x, depth_only, interpret,
):
    kernel = functools.partial(
        _raster_kernel,
        n_chunks=chunk_bbox.shape[0],
        depth_only=depth_only,
    )
    vma = _out_vma(coeffs, chunk_bbox, origin)
    shape = (tiles_y * TILE_H, tiles_x * TILE_W)
    dtypes = [jnp.float32] if depth_only else [
        jnp.float32, jnp.int32, jnp.float32, jnp.float32
    ]
    tile_spec = pl.BlockSpec((TILE_H, TILE_W), lambda i, j: (i, j))
    return pl.pallas_call(
        kernel,
        out_shape=[jax.ShapeDtypeStruct(shape, d, vma=vma) for d in dtypes],
        grid=(tiles_y, tiles_x),
        in_specs=[pl.BlockSpec()] * 3,
        out_specs=[tile_spec] * len(dtypes),
        interpret=interpret,
        backend="triton",
        compiler_params=pl_triton.CompilerParams(
            num_warps=NUM_WARPS, num_stages=1
        ),
        name="syzygy_raster",
    )(coeffs, chunk_bbox, origin)


def _origin_operand(origin) -> jnp.ndarray:
    if origin is None:
        return jnp.zeros((2,), jnp.int32)
    return jnp.asarray(origin, jnp.int32).reshape(2)


def _visibility(outs, width, height, depth_only) -> VisibilityBuffer:
    outs = [o[:height, :width] for o in outs]
    if depth_only:
        empty = jnp.zeros((0, 0))
        return VisibilityBuffer(depth=outs[0], tri=empty, b0=empty, b1=empty)
    return VisibilityBuffer(*outs)


@functools.partial(
    jax.jit,
    static_argnames=("width", "height", "depth_only"),
)
def rasterize(
    setup: TriSetup,
    width: int,
    height: int,
    depth_only: bool = False,
    origin=None,
) -> VisibilityBuffer:
    """Rasterize ``setup`` into a (height, width) visibility buffer.

    Any target size works: the grid rounds up to whole tiles and the
    result is cropped. ``origin`` = the target's global (oy, ox) pixel
    origin (may be traced; None = (0, 0)): a row block of a sharded frame
    evaluates the same global-coordinate arithmetic as the whole frame.

    The route is chosen per lowering platform: the Triton kernel when
    compiled for CUDA, the Pallas interpreter when compiled for the CPU
    (tests). Any other platform has no lowering and fails to compile."""
    call = functools.partial(
        _pallas_raster,
        tiles_y=cdiv(height, TILE_H),
        tiles_x=cdiv(width, TILE_W),
        depth_only=depth_only,
    )
    outs = jax.lax.platform_dependent(
        setup.coeffs,
        setup.chunk_bbox,
        _origin_operand(origin),
        cpu=functools.partial(call, interpret=True),
        cuda=functools.partial(call, interpret=False),
    )
    return _visibility(outs, width, height, depth_only)


@functools.partial(
    jax.jit,
    static_argnames=("width", "height", "depth_only"),
)
def rasterize_xla(
    setup: TriSetup,
    width: int,
    height: int,
    depth_only: bool = False,
    origin=None,
) -> VisibilityBuffer:
    """:func:`rasterize`'s contract in plain ``jax.numpy``/``lax``.

    Per tile, the chunks whose bbox overlaps it are compacted into an
    ascending list; step ``s`` of a while loop evaluates every tile's
    ``s``-th chunk over the whole tile as a (tiles, chunk, pixels) block and
    keeps the lexicographic max of (depth, slot) among hits, which is what
    the serial ``z >= current`` walk selects. Every tile runs for the
    longest list. The reference the kernel is tested and timed against."""
    n_chunks = setup.chunk_bbox.shape[0]
    chunk = setup.coeffs.shape[0] // n_chunks
    tiles_y, tiles_x = cdiv(height, TILE_H), cdiv(width, TILE_W)
    n_tiles = tiles_y * tiles_x
    org = _origin_operand(origin)
    ty, tx = jnp.divmod(jnp.arange(n_tiles, dtype=jnp.int32), tiles_x)
    x0 = (tx * TILE_W + org[1]).astype(jnp.float32)  # (tiles,)
    y0 = (ty * TILE_H + org[0]).astype(jnp.float32)

    cb = setup.chunk_bbox
    active = (
        (cb[None, :, 0] < (x0 + TILE_W)[:, None])
        & (cb[None, :, 1] >= x0[:, None])
        & (cb[None, :, 2] < (y0 + TILE_H)[:, None])
        & (cb[None, :, 3] >= y0[:, None])
    )  # (tiles, chunks)
    pos = jnp.cumsum(active, axis=1, dtype=jnp.int32) - 1
    # column n_chunks collects the inactive entries; unused list slots keep
    # chunk id n_chunks, the all-invalid pad chunk appended below
    table = (
        jnp.full((n_tiles, n_chunks + 1), n_chunks, jnp.int32)
        .at[jnp.arange(n_tiles)[:, None], jnp.where(active, pos, n_chunks)]
        .set(jnp.broadcast_to(jnp.arange(n_chunks, dtype=jnp.int32), active.shape))
    )
    steps = active.sum(axis=1).max()
    coeffs = jnp.concatenate(
        [setup.coeffs, jnp.zeros((chunk, _COEFF_WIDTH), jnp.float32)]
    ).reshape(n_chunks + 1, chunk, _COEFF_WIDTH)

    col = jnp.tile(jnp.arange(TILE_W, dtype=jnp.float32), TILE_H)
    row = jnp.repeat(jnp.arange(TILE_H, dtype=jnp.float32), TILE_W)
    px = (x0[:, None] + col[None, :] + 0.5)[:, None, :]  # (tiles, 1, P)
    py = (y0[:, None] + row[None, :] + 0.5)[:, None, :]

    def step(s, carry):
        ids = table[:, s]  # (tiles,)
        cf = coeffs[ids]  # (tiles, chunk, 16)
        c = [cf[:, :, k][:, :, None] for k in range(10)]
        bb0 = c[0] + c[1] * px + c[2] * py
        bb1 = c[3] + c[4] * px + c[5] * py
        bb2 = 1.0 - bb0 - bb1
        z = c[6] + c[7] * bb0 + c[8] * bb1
        hit = (
            (bb0 >= 0.0) & (bb1 >= 0.0) & (bb2 >= 0.0)
            & (z <= 1.0) & (z >= 0.0) & (c[9] > 0.0)
        )
        zm = jnp.where(hit, z, -1.0)  # the carried depth is >= 0
        if depth_only:
            best = zm.max(axis=1)
            return (jnp.where(best >= carry[0], best, carry[0]),)
        tid = jnp.broadcast_to(
            ids[:, None, None] * chunk
            + jnp.arange(chunk, dtype=jnp.int32)[None, :, None],
            zm.shape,
        )

        def pick(a, b):
            take_b = (b[0] > a[0]) | ((b[0] == a[0]) & (b[1] > a[1]))
            return tuple(jnp.where(take_b, y, x) for x, y in zip(a, b))

        best = jax.lax.reduce(
            (zm, tid, bb0, bb1),
            (jnp.float32(-2.0), jnp.int32(-1), jnp.float32(0), jnp.float32(0)),
            pick,
            (1,),
        )
        upd = best[0] >= carry[0]
        return tuple(jnp.where(upd, b, old) for b, old in zip(best, carry))

    p = TILE_H * TILE_W
    zeros = jnp.zeros((n_tiles, p), jnp.float32)
    init = (zeros,) if depth_only else (
        zeros, jnp.full((n_tiles, p), -1, jnp.int32), zeros, zeros
    )
    out = jax.lax.fori_loop(0, steps, step, init)
    outs = [
        o.reshape(tiles_y, tiles_x, TILE_H, TILE_W)
        .transpose(0, 2, 1, 3)
        .reshape(tiles_y * TILE_H, tiles_x * TILE_W)
        for o in out
    ]
    return _visibility(outs, width, height, depth_only)

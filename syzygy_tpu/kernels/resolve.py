"""G-buffer resolve: visibility buffer -> shaded attribute planes.

The software half of the reference's G-buffer fragment work
(``shaders/deferred/offscreen.vert`` + ``offscreen.frag``): where Vulkan
interpolates attributes per fragment in hardware, here a vectorized jnp pass
gathers per-pixel triangle attributes through the visibility buffer's tri id,
applies perspective-correct barycentric interpolation, samples material
textures (bilinear + REPEAT), and perturbs normals with an analytic
cotangent frame (replacing dFdx/dFdy, ``offscreen.frag:25-59`` — screen
derivatives of affine per-triangle attributes equal the triangle-edge
solution, so the frame is computed from world/UV edge deltas instead).

G-buffer layout mirrors ``renderer/gbuffer.cpp:27-44``: diffuse, specular,
normal, worldPosition, occlusionRoughnessMetallic; background texels have
diffuse alpha 0 (< 1 marks background in ``deferred/lights.comp:126-129``).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from syzygy_tpu.kernels.raster import TriSetup, VisibilityBuffer
from syzygy_tpu.scene.pack import GeometryStatic


class GBuffer(NamedTuple):
    """5-plane G-buffer (``renderer/gbuffer.cpp:27-44``)."""

    diffuse: jnp.ndarray  # (H, W, 4)
    specular: jnp.ndarray  # (H, W, 4)
    normal: jnp.ndarray  # (H, W, 4)
    world_position: jnp.ndarray  # (H, W, 4)
    orm: jnp.ndarray  # (H, W, 4)


def transform_positions(
    positions: jnp.ndarray,  # (V, 3) object space
    vert_instance: jnp.ndarray,  # (V,) i32
    models: jnp.ndarray,  # (I, 4, 4)
    proj_view: jnp.ndarray,  # (4, 4)
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Vertex stage (``offscreen.vert:41-51``): world + clip positions."""
    m = models[vert_instance]  # (V, 4, 4)
    pos_h = jnp.concatenate(
        [positions, jnp.ones((*positions.shape[:-1], 1), jnp.float32)], axis=-1
    )
    world = jnp.einsum("vij,vj->vi", m, pos_h)  # (V, 4)
    clip = world @ proj_view.T  # (V, 4)
    return clip, world[..., :3]


def transform_normals(
    normals: jnp.ndarray,
    vert_instance: jnp.ndarray,
    model_inv_transpose: jnp.ndarray,
) -> jnp.ndarray:
    """``offscreen.vert:53``: normalize((modelInverseTranspose * n).xyz)."""
    m = model_inv_transpose[vert_instance][..., :3, :3]
    n = jnp.einsum("vij,vj->vi", m, normals)
    return n / jnp.maximum(jnp.linalg.norm(n, axis=-1, keepdims=True), 1e-20)


def sample_bilinear_repeat(
    tex_ids: jnp.ndarray,  # (...,) i32 into the texture array
    textures: jnp.ndarray,  # (N, S, S, 4)
    uv: jnp.ndarray,  # (..., 2)
) -> jnp.ndarray:
    """Bilinear + REPEAT sampling from the texture array (descriptor-set
    replacement). All taps are vectorized gathers."""
    size = textures.shape[1]
    p = uv * size - 0.5
    p0 = jnp.floor(p)
    frac = p - p0
    i0 = jnp.mod(p0.astype(jnp.int32), size)
    i1 = jnp.mod(i0 + 1, size)
    x0, y0 = i0[..., 0], i0[..., 1]
    x1, y1 = i1[..., 0], i1[..., 1]
    fx, fy = frac[..., 0:1], frac[..., 1:2]

    t00 = textures[tex_ids, y0, x0]
    t10 = textures[tex_ids, y0, x1]
    t01 = textures[tex_ids, y1, x0]
    t11 = textures[tex_ids, y1, x1]
    top = t00 * (1.0 - fx) + t10 * fx
    bot = t01 * (1.0 - fx) + t11 * fx
    return top * (1.0 - fy) + bot * fy


def sample_atlas_repeat(
    tex_ids: jnp.ndarray,  # (...,) i32 into the rect table
    atlas: jnp.ndarray,  # (A_h, A_w, 4) f32
    rects: jnp.ndarray,  # (N, 4) i32 [x0, y0, w, h]
    uv: jnp.ndarray,  # (..., 2)
) -> jnp.ndarray:
    """Bilinear + REPEAT sampling from the native-resolution texture atlas.

    Each texture keeps its source resolution (the reference decodes images
    at native size, ``assets.cpp:470-575``); REPEAT wraps within the
    texture's own rect, and all four taps are wrapped per-texel before the
    atlas offset is applied, so filtering is seam-correct across the wrap.
    """
    return _sample_atlas_rect(rects[tex_ids], atlas, uv)


def sample_atlas_trilinear(
    tex_ids: jnp.ndarray,  # (...,) i32 into the rect table
    atlas: jnp.ndarray,  # (A_h, A_w, 4) f32
    rects_mips: jnp.ndarray,  # (N, L, 4) i32 per-level rects
    uv: jnp.ndarray,  # (..., 2)
    lod: jnp.ndarray,  # (...,) f32 mip level (continuous)
) -> jnp.ndarray:
    """Trilinear (mipmapped) atlas sampling — beyond-parity quality
    (the reference allocates single-mip images, ``assets.cpp:701-711``).
    Two bilinear taps at floor/ceil levels, lerped by the lod fraction."""
    n_levels = rects_mips.shape[1]
    lod = jnp.clip(lod, 0.0, n_levels - 1.0)
    l0 = jnp.floor(lod).astype(jnp.int32)
    l1 = jnp.minimum(l0 + 1, n_levels - 1)
    fl = (lod - l0)[..., None]
    a = _sample_atlas_rect(rects_mips[tex_ids, l0], atlas, uv)
    b = _sample_atlas_rect(rects_mips[tex_ids, l1], atlas, uv)
    return a * (1.0 - fl) + b * fl


def _sample_atlas_rect(
    r: jnp.ndarray,  # (..., 4) i32 [x0, y0, w, h] per sample
    atlas: jnp.ndarray,  # (A_h, A_w, 4) plain or (A_h, A_w, 16) quad-packed
    uv: jnp.ndarray,
) -> jnp.ndarray:
    x0r, y0r = r[..., 0], r[..., 1]
    w = r[..., 2]
    h = r[..., 3]
    p_x = uv[..., 0] * w.astype(jnp.float32) - 0.5
    p_y = uv[..., 1] * h.astype(jnp.float32) - 0.5
    fx0 = jnp.floor(p_x)
    fy0 = jnp.floor(p_y)
    fracx = (p_x - fx0)[..., None]
    fracy = (p_y - fy0)[..., None]
    ix0 = jnp.mod(fx0.astype(jnp.int32), w)
    iy0 = jnp.mod(fy0.astype(jnp.int32), h)

    if atlas.shape[-1] == 16:  # quad-packed (assets.types.quad_pack_atlas)
        q = atlas[y0r + iy0, x0r + ix0]  # one gather: the 2x2 footprint
        q = q.astype(jnp.float32)  # no-op for f32 atlases (atlas_f16)
        t00, t10 = q[..., 0:4], q[..., 4:8]
        t01, t11 = q[..., 8:12], q[..., 12:16]
    else:
        ix1 = jnp.where(ix0 + 1 >= w, 0, ix0 + 1)
        iy1 = jnp.where(iy0 + 1 >= h, 0, iy0 + 1)
        t00 = atlas[y0r + iy0, x0r + ix0].astype(jnp.float32)
        t10 = atlas[y0r + iy0, x0r + ix1].astype(jnp.float32)
        t01 = atlas[y0r + iy1, x0r + ix0].astype(jnp.float32)
        t11 = atlas[y0r + iy1, x0r + ix1].astype(jnp.float32)
    top = t00 * (1.0 - fracx) + t10 * fracx
    bot = t01 * (1.0 - fracx) + t11 * fracx
    return top * (1.0 - fracy) + bot * fracy


def _cotangent_frame_normal(
    n: jnp.ndarray,  # (H, W, 3) interpolated vertex normal
    dp1: jnp.ndarray,  # (H, W, 3) triangle world edge 1
    dp2: jnp.ndarray,  # (H, W, 3) triangle world edge 2
    duv1: jnp.ndarray,  # (H, W, 2)
    duv2: jnp.ndarray,  # (H, W, 2)
    normal_map: jnp.ndarray,  # (H, W, 3) decoded tangent-space normal
) -> jnp.ndarray:
    """``cotangentFrame`` + ``perturbNormal`` (``offscreen.frag:25-59``)."""
    dp2perp = jnp.cross(dp2, n)
    dp1perp = jnp.cross(n, dp1)
    t = dp2perp * duv1[..., 0:1] + dp1perp * duv2[..., 0:1]
    b = dp2perp * duv1[..., 1:2] + dp1perp * duv2[..., 1:2]
    invmax = 1.0 / jnp.sqrt(
        jnp.maximum(
            jnp.maximum(
                jnp.sum(t * t, axis=-1, keepdims=True),
                jnp.sum(b * b, axis=-1, keepdims=True),
            ),
            1e-20,
        )
    )
    perturbed = (
        t * invmax * normal_map[..., 0:1]
        + b * invmax * normal_map[..., 1:2]
        + n * normal_map[..., 2:3]
    )
    return perturbed / jnp.maximum(
        jnp.linalg.norm(perturbed, axis=-1, keepdims=True), 1e-20
    )


# 41 when the geometry carries a joint material atlas (rect only);
# 47 for the mixed-dim neighborhood joint atlas (rect + 3x(w,h))
RECORD_WIDTH = 49


def _sample_atlas_rect_joint(
    r: jnp.ndarray,  # (..., 4) i32 [x0, y0, w, h] joint material rect
    atlas: jnp.ndarray,  # (J_h, J_w, 48) joint quad-packed atlas
    uv: jnp.ndarray,
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """One 48-channel gather -> (color, normal, orm) bilinear samples.

    The three 16-channel groups hold each map's quad-packed 2x2 footprint
    at the SAME within-rect texel (materials qualify only when the maps
    share dimensions), so the per-map interpolation below is elementwise
    identical to three separate :func:`_sample_atlas_rect` calls —
    bitwise-equal results with 1/3 the gathers."""
    x0r, y0r = r[..., 0], r[..., 1]
    w = r[..., 2]
    h = r[..., 3]
    p_x = uv[..., 0] * w.astype(jnp.float32) - 0.5
    p_y = uv[..., 1] * h.astype(jnp.float32) - 0.5
    fx0 = jnp.floor(p_x)
    fy0 = jnp.floor(p_y)
    fracx = (p_x - fx0)[..., None]
    fracy = (p_y - fy0)[..., None]
    ix0 = jnp.mod(fx0.astype(jnp.int32), w)
    iy0 = jnp.mod(fy0.astype(jnp.int32), h)
    q = atlas[y0r + iy0, x0r + ix0]  # (..., 48): the one gather
    q = q.astype(jnp.float32)  # no-op for f32 atlases (atlas_f16)

    def lerp(g):
        t00, t10 = q[..., g : g + 4], q[..., g + 4 : g + 8]
        t01, t11 = q[..., g + 8 : g + 12], q[..., g + 12 : g + 16]
        top = t00 * (1.0 - fracx) + t10 * fracx
        bot = t01 * (1.0 - fracx) + t11 * fracx
        return top * (1.0 - fracy) + bot * fracy

    return lerp(0), lerp(16), lerp(32)


def _sample_atlas_rect_joint_nbhd(
    r: jnp.ndarray,  # (..., 4) i32 [x0, y0, W, H] joint rect (fine dims)
    dims: jnp.ndarray,  # (..., 3, 2) i32 per-role (w, h)
    atlas: jnp.ndarray,  # (J_h, J_w, 108) neighborhood joint atlas
    uv: jnp.ndarray,
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """One 108-channel gather -> (color, normal, orm) bilinear samples for
    MIXED-dimension materials — bitwise equal to three separate
    :func:`_sample_atlas_rect` calls (layout + exactness proof:
    ``assets.types.joint_pack_atlas_nbhd``).

    Each role recomputes its own p = u*w - 0.5 / floor / mod with the
    identical f32 ops as the separate path, then selects its 2x2 footprint
    out of the stored 3x3 neighborhood with a per-axis offset
    d = (own base - stored base F) mod w, which the power-of-two-ratio
    construction pins to {0, 1}. Selects commute with the bilinear
    arithmetic lane-wise, so the lerp below is bit-identical to lerping
    the selected texels."""
    x0r, y0r = r[..., 0], r[..., 1]
    fw = r[..., 2]
    fh = r[..., 3]
    p_X = uv[..., 0] * fw.astype(jnp.float32) - 0.5
    p_Y = uv[..., 1] * fh.astype(jnp.float32) - 0.5
    ixf = jnp.mod(jnp.floor(p_X).astype(jnp.int32), fw)
    iyf = jnp.mod(jnp.floor(p_Y).astype(jnp.int32), fh)
    q = atlas[y0r + iyf, x0r + ixf]  # (..., 108): the one gather
    q = q.astype(jnp.float32)  # no-op for f32 atlases (atlas_f16)

    def sample_role(role):
        w = dims[..., role, 0]
        h = dims[..., role, 1]
        # identical op sequence to _sample_atlas_rect
        p_x = uv[..., 0] * w.astype(jnp.float32) - 0.5
        p_y = uv[..., 1] * h.astype(jnp.float32) - 0.5
        fx0 = jnp.floor(p_x)
        fy0 = jnp.floor(p_y)
        fracx = (p_x - fx0)[..., None]
        fracy = (p_y - fy0)[..., None]
        ix0 = jnp.mod(fx0.astype(jnp.int32), w)
        iy0 = jnp.mod(fy0.astype(jnp.int32), h)
        # stored neighborhood base F = floor((ix_fine + 0.5)/k - 0.5)
        # = floor_div(2*ix_fine + 1 - k, 2*k), wrapped into the role map
        kx = fw // w
        ky = fh // h
        fx = jnp.mod(jnp.floor_divide(2 * ixf + 1 - kx, 2 * kx), w)
        fy = jnp.mod(jnp.floor_divide(2 * iyf + 1 - ky, 2 * ky), h)
        dx = (jnp.mod(ix0 - fx, w) != 0)[..., None]  # {0,1} by construction
        dy = (jnp.mod(iy0 - fy, h) != 0)[..., None]
        base = role * 36

        def nb(j, i):
            c = base + (j * 3 + i) * 4
            return q[..., c : c + 4]

        # select columns (dx, dx+1) per stored row, fold the x-lerp, then
        # select rows (dy, dy+1)
        rowv = []
        for j in range(3):
            left = jnp.where(dx, nb(j, 1), nb(j, 0))
            right = jnp.where(dx, nb(j, 2), nb(j, 1))
            rowv.append(left * (1.0 - fracx) + right * fracx)
        top = jnp.where(dy, rowv[1], rowv[0])
        bot = jnp.where(dy, rowv[2], rowv[1])
        return top * (1.0 - fracy) + bot * fracy

    return sample_role(0), sample_role(1), sample_role(2)


def build_resolve_records(
    setup: TriSetup,
    geometry: GeometryStatic,
    world_positions: jnp.ndarray,  # (V, 3)
    world_normals: jnp.ndarray,  # (V, 3)
    shard_axis: str | None = None,
) -> jnp.ndarray:
    """Pre-joined per-clipped-triangle attribute records, (T2, 49) f32.

    The resolve's per-pixel data is all affine per-triangle: instead of ~8
    separate (H, W)-row gathers per pixel (orig tri id, corner bary, corner
    w, vertex indices, 3 attribute fetches, material id, rect rows), join
    everything into one record per clipped-triangle slot at setup time so
    the pixel pass does ONE wide gather. Corner attributes are
    pre-mapped through the clip-corner barycentrics, so pixel interpolation
    uses the raster triangle's perspective weights directly (algebraically
    identical to interpolating original-corner attributes; float order
    differs at rounding level). Replaces hardware per-fragment attribute
    interpolation (``shaders/deferred/offscreen.vert:41-56``).

    Layout: 0:3 corner w | 3:12 corner world pos | 12:21 corner normals |
    21:27 corner uvs | 27:30 dp1 | 30:33 dp2 | 33:35 duv1 | 35:37 duv2 |
    37:49 color/normal/orm atlas rects (exact small ints in f32) — or,
    when the geometry carries a joint material atlas
    (``tex_rects_joint``), 37:41 the material's single joint rect
    (record width 41; the mixed-dim neighborhood variant appends the
    per-role dims at 41:47, width 47).

    The build itself needs NO per-slot gathers: ``setup.orig_tri`` is
    statically ``concat(arange(T), arange(T))`` + zero padding
    (setup_triangles' slot layout), so per-ORIGINAL-triangle tables (one
    T-row gather each) tile straight into slot order.
    """
    t2_pad = setup.orig_tri.shape[0]
    n_t = geometry.triangles.shape[0]
    assert t2_pad >= 2 * n_t, (t2_pad, n_t)

    if shard_axis is not None and (
        jax.lax.axis_size(shard_axis) == 1
        or n_t % jax.lax.axis_size(shard_axis) != 0
    ):
        # axis size 1 would be identity slice+gather copies of the whole
        # records table (see setup_triangles); exotic device counts keep
        # the replicated build
        shard_axis = None
    if shard_axis is None:
        rows = _record_rows(
            geometry.triangles,
            geometry.tri_material,
            setup.corner_bary[: 2 * n_t],
            setup.corner_w[: 2 * n_t],
            geometry,
            world_positions,
            world_normals,
        )
    else:
        # Shard the O(T) table gathers over the mesh axis (the same
        # pattern as setup_triangles' shard_axis): each device builds the
        # records for a T/n_dev triangle slice — BOTH its A and B slots,
        # which share the per-triangle gathers — and an all_gather rejoins
        # them in canonical [A block, B block] slot order. Bitwise: row
        # slices of elementwise math.
        n_dev = jax.lax.axis_size(shard_axis)
        my = jax.lax.axis_index(shard_axis)
        loc = n_t // n_dev
        start = my * loc

        def sl(x, off=0):
            return jax.lax.dynamic_slice_in_dim(x, off + start, loc)

        def slot2(x):  # matching [A slice; B slice] slot rows
            return jnp.concatenate([sl(x), sl(x, n_t)], axis=0)

        local = _record_rows(
            sl(geometry.triangles),
            sl(geometry.tri_material),
            slot2(setup.corner_bary),
            slot2(setup.corner_w),
            geometry,
            world_positions,
            world_normals,
        )
        g = jax.lax.all_gather(local, shard_axis)  # (n_dev, 2*loc, W)
        a = g[:, :loc].reshape(n_t, g.shape[-1])
        b = g[:, loc:].reshape(n_t, g.shape[-1])
        rows = jnp.concatenate([a, b], axis=0)
    pad = t2_pad - rows.shape[0]
    if pad:
        # pad slots keep corner_w == 1 (cols 0:3), matching TriSetup's own
        # padding: background pixels gather SOME record row (vis.tri == -1
        # wraps), and a zero w would manufacture 0/0 NaNs upstream of the
        # background mask
        pad_rows = jnp.concatenate(
            [
                jnp.ones((pad, 3), rows.dtype),
                jnp.zeros((pad, rows.shape[1] - 3), rows.dtype),
            ],
            axis=-1,
        )
        rows = jnp.concatenate([rows, pad_rows], axis=0)
    return rows


def _record_rows(
    tris,  # (L, 3) triangle slice
    mats,  # (L,) material ids
    cb,  # (2L, 3, 2) corner bary for the matching [A; B] slots
    corner_w,  # (2L, 3)
    geometry: GeometryStatic,
    world_positions: jnp.ndarray,
    world_normals: jnp.ndarray,
) -> jnp.ndarray:
    """Records for one triangle slice's [A slots; B slots] (2L rows).

    The per-triangle table gathers (positions/normals/uvs/rects — the O(T)
    cost) run once per input triangle and tile over both slots."""

    def tile2(table):  # (L, ...) -> (2L, ...)
        return jnp.concatenate([table, table], axis=0)

    p = tile2(world_positions[tris])  # (2L, 3, 3) original corners
    n = tile2(world_normals[tris])  # (2L, 3, 3)
    u = tile2(geometry.uvs[tris])  # (2L, 3, 2)
    w3 = jnp.concatenate([cb, 1.0 - cb[..., 0:1] - cb[..., 1:2]], axis=-1)
    cp = jnp.einsum("tkj,tjc->tkc", w3, p)  # clipped corners' attributes
    cn = jnp.einsum("tkj,tjc->tkc", w3, n)
    cu = jnp.einsum("tkj,tjc->tkc", w3, u)
    t2 = 2 * tris.shape[0]
    if geometry.tex_rects_joint is not None:
        rect_cols = tile2(
            geometry.tex_rects_joint[mats]
        ).astype(jnp.float32)  # (2L, 4)
        if geometry.tex_dims_joint is not None:
            # mixed-dim neighborhood joint atlas: the sampler recomputes
            # each role's own index math from its (w, h)
            dims_cols = tile2(
                geometry.tex_dims_joint[mats].reshape(-1, 6)
            ).astype(jnp.float32)  # (2L, 6) -> record width 47
            rect_cols = jnp.concatenate([rect_cols, dims_cols], axis=-1)
    else:
        rect_cols = tile2(
            geometry.tex_rects[geometry.materials[mats]]
        ).reshape(t2, 12).astype(jnp.float32)  # (2L, 12)
    return jnp.concatenate(
        [
            corner_w,
            cp.reshape(t2, 9),
            cn.reshape(t2, 9),
            cu.reshape(t2, 6),
            p[:, 1] - p[:, 0],
            p[:, 2] - p[:, 0],
            u[:, 1] - u[:, 0],
            u[:, 2] - u[:, 0],
            rect_cols,
        ],
        axis=-1,
    )


def resolve_gbuffer(
    vis: VisibilityBuffer,
    setup: TriSetup,
    geometry: GeometryStatic,
    world_positions: jnp.ndarray,  # (V, 3)
    world_normals: jnp.ndarray,  # (V, 3)
) -> GBuffer:
    """Visibility buffer -> 5 G-buffer planes.

    Single-mip path: ONE pre-joined record gather + 3 atlas samples per
    pixel (:func:`build_resolve_records`). Mipmapped path (beyond-parity)
    keeps the multi-gather formulation (LOD-dependent rect rows can't be
    pre-joined)."""
    if geometry.tex_rects_mips is not None:
        return _resolve_gbuffer_gathered(
            vis, setup, geometry, world_positions, world_normals
        )
    records = build_resolve_records(
        setup, geometry, world_positions, world_normals
    )
    return resolve_gbuffer_from_records(vis, records, geometry)


def resolve_gbuffer_from_records(
    vis: VisibilityBuffer,
    records: jnp.ndarray,  # (T2, 49) from build_resolve_records
    geometry: GeometryStatic,
) -> GBuffer:
    """The purely per-pixel tail of :func:`resolve_gbuffer` (single-mip
    path): one record gather + atlas samples per pixel. Split out so the
    frame graph can run it per row chunk inside the lighting+sky program
    (RenderConfig.resolve_in_sky_chunks) — every input beyond ``vis`` is
    a per-triangle/atlas table, so row-slicing ``vis`` is exact."""
    valid = vis.tri >= 0  # (H, W)
    tid = jnp.maximum(vis.tri, 0)
    rec = records[tid]  # (H, W, 49): the one per-pixel record gather

    corner_w = rec[..., 0:3]
    sb = jnp.stack([vis.b0, vis.b1, 1.0 - vis.b0 - vis.b1], axis=-1)
    pc = sb / jnp.maximum(corner_w, 1e-8)
    pc = pc / jnp.maximum(jnp.sum(pc, axis=-1, keepdims=True), 1e-20)

    hw = tid.shape

    def interp(lo, c):  # corner-major (3, c) block at channel offset lo
        block = rec[..., lo : lo + 3 * c].reshape(*hw, 3, c)
        return jnp.einsum("hwk,hwkc->hwc", pc, block)

    position = interp(3, 3)
    normal_geo = interp(12, 3)
    normal_geo = normal_geo / jnp.maximum(
        jnp.linalg.norm(normal_geo, axis=-1, keepdims=True), 1e-20
    )
    uv = interp(21, 2)

    if geometry.tex_atlas_joint is not None:
        if geometry.tex_dims_joint is not None:
            color_tex, normal_tex, orm_tex = _sample_atlas_rect_joint_nbhd(
                rec[..., 37:41].astype(jnp.int32),
                rec[..., 41:47].astype(jnp.int32).reshape(*hw, 3, 2),
                geometry.tex_atlas_joint,
                uv,
            )
        else:
            color_tex, normal_tex, orm_tex = _sample_atlas_rect_joint(
                rec[..., 37:41].astype(jnp.int32),
                geometry.tex_atlas_joint,
                uv,
            )
    else:
        atlas = geometry.tex_atlas
        color_tex = _sample_atlas_rect(
            rec[..., 37:41].astype(jnp.int32), atlas, uv
        )
        normal_tex = _sample_atlas_rect(
            rec[..., 41:45].astype(jnp.int32), atlas, uv
        )
        orm_tex = _sample_atlas_rect(
            rec[..., 45:49].astype(jnp.int32), atlas, uv
        )

    # Normal map decode (offscreen.frag:50-55): unsigned -> signed, green-up
    nmap = normal_tex[..., :3] * (255.0 / 127.0) - (128.0 / 127.0)
    nmap = nmap * jnp.array([1.0, -1.0, 1.0], jnp.float32)
    normal = _cotangent_frame_normal(
        normal_geo,
        rec[..., 27:30],
        rec[..., 30:33],
        rec[..., 33:35],
        rec[..., 35:37],
        nmap,
    )

    valid_f = valid[..., None].astype(jnp.float32)

    def plane(rgb, alpha):
        return jnp.concatenate([rgb, alpha], axis=-1) * valid_f

    ones = jnp.ones((*valid.shape, 1), jnp.float32)
    return GBuffer(
        diffuse=plane(color_tex[..., :3], ones),
        specular=plane(color_tex[..., :3], ones),
        normal=plane(normal, jnp.zeros_like(ones)),
        world_position=plane(position, ones),
        orm=plane(orm_tex[..., :3], ones),
    )


def _resolve_gbuffer_gathered(
    vis: VisibilityBuffer,
    setup: TriSetup,
    geometry: GeometryStatic,
    world_positions: jnp.ndarray,  # (V, 3)
    world_normals: jnp.ndarray,  # (V, 3)
) -> GBuffer:
    """Multi-gather resolve (mipmapped path; one big gather pass)."""
    valid = vis.tri >= 0  # (H, W)
    tid = jnp.maximum(vis.tri, 0)

    orig = setup.orig_tri[tid]  # (H, W)
    corner = setup.corner_bary[tid]  # (H, W, 3, 2)
    corner_w = setup.corner_w[tid]  # (H, W, 3)

    sb = jnp.stack([vis.b0, vis.b1, 1.0 - vis.b0 - vis.b1], axis=-1)  # (H,W,3)
    # 1) perspective-correct weights wrt the (possibly clipped) raster triangle
    pc = sb / jnp.maximum(corner_w, 1e-8)
    pc = pc / jnp.maximum(jnp.sum(pc, axis=-1, keepdims=True), 1e-20)
    # 2) map to ORIGINAL-triangle weights through the clip-space corner bary
    #    (affine in object space, so attributes interpolate linearly in them)
    ob01 = jnp.einsum("hwk,hwkc->hwc", pc, corner)  # (H, W, 2)
    pw = jnp.concatenate(
        [ob01, 1.0 - ob01[..., 0:1] - ob01[..., 1:2]], axis=-1
    )  # (H, W, 3)

    idx = geometry.triangles[orig]  # (H, W, 3)

    def interp(attr):  # attr: (V, C) -> (H, W, C)
        vals = attr[idx]  # (H, W, 3, C)
        return jnp.einsum("hwk,hwkc->hwc", pw, vals)

    position = interp(world_positions)
    normal_geo = interp(world_normals)
    normal_geo = normal_geo / jnp.maximum(
        jnp.linalg.norm(normal_geo, axis=-1, keepdims=True), 1e-20
    )
    uv = interp(geometry.uvs)

    mat = geometry.materials[geometry.tri_material[orig]]  # (H, W, 3)
    atlas, rects = geometry.tex_atlas, geometry.tex_rects
    if geometry.tex_rects_mips is not None:
        # screen-space uv footprint via finite differences (hardware dFdx
        # analog). Differences against a neighbor that is background or a
        # different triangle are garbage (silhouettes would over-blur, and
        # jnp.roll's wraparound would difference row/col 0 against the
        # opposite screen edge) — mask those to 0, which resolves to LOD 0
        # (sharp) at edges, the same failure direction GPU 2x2 quad
        # derivatives choose at partial quads.
        same_x = (jnp.roll(orig, 1, axis=1) == orig) & valid & jnp.roll(
            valid, 1, axis=1
        )
        same_x = same_x.at[:, 0].set(False)
        same_y = (jnp.roll(orig, 1, axis=0) == orig) & valid & jnp.roll(
            valid, 1, axis=0
        )
        same_y = same_y.at[0, :].set(False)
        dudx = jnp.where(
            same_x[..., None], jnp.abs(uv - jnp.roll(uv, 1, axis=1)), 0.0
        )
        dudy = jnp.where(
            same_y[..., None], jnp.abs(uv - jnp.roll(uv, 1, axis=0)), 0.0
        )
        rect0 = geometry.tex_rects_mips[:, 0]  # (N, 4) level-0 dims

        def lod_for(ids):
            dims = rect0[ids][..., 2:4].astype(jnp.float32)  # (H, W, 2)
            fp = jnp.maximum(
                jnp.max(dudx * dims, axis=-1), jnp.max(dudy * dims, axis=-1)
            )
            return jnp.log2(jnp.maximum(fp, 1.0))

        mips = geometry.tex_rects_mips
        color_tex = sample_atlas_trilinear(
            mat[..., 0], atlas, mips, uv, lod_for(mat[..., 0])
        )
        normal_tex = sample_atlas_trilinear(
            mat[..., 1], atlas, mips, uv, lod_for(mat[..., 1])
        )
        orm_tex = sample_atlas_trilinear(
            mat[..., 2], atlas, mips, uv, lod_for(mat[..., 2])
        )
    else:
        color_tex = sample_atlas_repeat(mat[..., 0], atlas, rects, uv)
        normal_tex = sample_atlas_repeat(mat[..., 1], atlas, rects, uv)
        orm_tex = sample_atlas_repeat(mat[..., 2], atlas, rects, uv)

    # Normal map decode (offscreen.frag:50-55): unsigned -> signed, green-up
    nmap = normal_tex[..., :3] * (255.0 / 127.0) - (128.0 / 127.0)
    nmap = nmap * jnp.array([1.0, -1.0, 1.0], jnp.float32)

    # per-original-triangle world/uv edges for the analytic cotangent frame
    v0, v1, v2 = idx[..., 0], idx[..., 1], idx[..., 2]
    dp1 = world_positions[v1] - world_positions[v0]
    dp2 = world_positions[v2] - world_positions[v0]
    duv1 = geometry.uvs[v1] - geometry.uvs[v0]
    duv2 = geometry.uvs[v2] - geometry.uvs[v0]
    normal = _cotangent_frame_normal(normal_geo, dp1, dp2, duv1, duv2, nmap)

    valid_f = valid[..., None].astype(jnp.float32)

    def plane(rgb, alpha):
        return jnp.concatenate([rgb, alpha], axis=-1) * valid_f

    ones = jnp.ones((*valid.shape, 1), jnp.float32)
    return GBuffer(
        diffuse=plane(color_tex[..., :3], ones),
        specular=plane(color_tex[..., :3], ones),
        normal=plane(normal, jnp.zeros_like(ones)),
        world_position=plane(position, ones),
        orm=plane(orm_tex[..., :3], ones),
    )

"""Scene -> device arrays, split host-cheap / device-jit.

The replacement for the reference's staged-buffer uploads
(``renderer/renderer.cpp:302-366``), designed so the per-frame host path is
numpy-only (microseconds):

* :func:`pack_geometry` -> :class:`GeometryStatic` — topology, vertex data,
  materials, textures. Rebuilt only on scene-graph edits. Vertices are
  replicated per instance (instancing becomes a gather of the per-instance
  model matrix, ``deferred/offscreen.vert:43-51``); counts are padded to
  chunk multiples with validity masks.
* :func:`pack_frame_params` -> :class:`FrameParams` — tiny raw numpy arrays:
  instance TRS (post-animation), camera scalars, sun angles, light params,
  shadow bounds. No jnp calls.
* :func:`prepare_frame_state` -> :class:`FrameState` — runs INSIDE the jitted
  frame: builds model matrices, camera pack, sun/moon bake, spot lights on
  device; the host never blocks on it.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from syzygy_tpu.math.geometry import inverse4, orientate4
from syzygy_tpu.scene.atmosphere import (
    AtmospherePacked,
    AtmosphereRaw,
    atmosphere_raw,
    bake_directional,
    pack_atmosphere,
)
from syzygy_tpu.scene.camera import CameraPacked, pack_camera
from syzygy_tpu.scene.lights import (
    MAX_SPOT_LIGHTS,
    DirectionalLight,
    SpotLight,
    SpotRaw,
    make_spot_batched,
    spot_raw,
)
from syzygy_tpu.scene.scene import Scene

VERTEX_PAD = 128
TRI_PAD = 128


class GeometryStatic(NamedTuple):
    """Static scene topology (device)."""

    positions: jnp.ndarray  # (V, 3) f32, object space
    normals: jnp.ndarray  # (V, 3) f32
    uvs: jnp.ndarray  # (V, 2) f32
    colors: jnp.ndarray  # (V, 4) f32
    vert_instance: jnp.ndarray  # (V,) i32 -> models row
    triangles: jnp.ndarray  # (T, 3) i32 into the arrays above
    tri_material: jnp.ndarray  # (T,) i32 -> materials row
    tri_valid: jnp.ndarray  # (T,) bool
    tri_casts_shadow: jnp.ndarray  # (T,) bool
    materials: jnp.ndarray  # (M, 3) i32: color/normal/orm texture ids
    # native-resolution texture atlas (assets/types.py::TextureLibrary):
    # (A_h, A_w, 16) f32 quad-packed by default — each texel carries its
    # 2x2 bilinear footprint so a sample is ONE gather (4x the memory of the
    # plain layout; pack_geometry(quad_pack=False) keeps (A_h, A_w, 4))
    tex_atlas: jnp.ndarray  # linear light
    tex_rects: jnp.ndarray  # (N, 4) i32 [x0, y0, w, h] per texture
    # optional mip pyramid (pack_geometry(mipmaps=True); beyond-parity —
    # the reference is single-mip): (N, L, 4) i32 per-level rects into the
    # same atlas, or None for single-mip sampling
    tex_rects_mips: jnp.ndarray | None = None
    # optional per-MATERIAL joint atlas (assets.types.joint_pack_atlas):
    # (J_h, J_w, 48) f32 — color/normal/orm quad-packed texels stacked
    # channel-wise so the resolve samples all three maps with ONE gather.
    # Present only when every material's three textures share dimensions
    # (and quad_pack, single-mip); bitwise-identical sampling either way.
    tex_atlas_joint: jnp.ndarray | None = None
    tex_rects_joint: jnp.ndarray | None = None  # (M, 4) i32 per material
    # set only for the mixed-dimension neighborhood joint atlas
    # (assets.types.joint_pack_atlas_nbhd — (J_h, J_w, 108) in
    # tex_atlas_joint): per-role (w, h) so the resolve can recompute each
    # map's own bilinear index math bitwise; None for the 48ch equal-dims
    # joint atlas.
    tex_dims_joint: jnp.ndarray | None = None  # (M, 3, 2) i32


class FrameParams(NamedTuple):
    """Per-frame raw state (host numpy; becomes traced input of the frame)."""

    translations: np.ndarray  # (I, 3)
    euler_angles: np.ndarray  # (I, 3)
    scales: np.ndarray  # (I, 3)
    cam_position: np.ndarray  # (3,)
    cam_euler_angles: np.ndarray  # (3,)
    cam_fov_degrees: np.ndarray  # ()
    cam_near: np.ndarray  # ()
    cam_far: np.ndarray  # ()
    aspect_ratio: np.ndarray  # ()
    atmosphere: AtmosphereRaw
    bounds_min: np.ndarray  # (3,) shadow bounds (scene.cpp:95-148)
    bounds_max: np.ndarray  # (3,)
    spots: SpotRaw
    spot_count: np.ndarray  # i32
    directional_skip_count: np.ndarray  # i32 (1 when sky pass lights the sun)
    debug_segments: np.ndarray  # (S, 2, 3) world-space debug line endpoints
    debug_valid: np.ndarray  # (S,) bool


class FrameState(NamedTuple):
    """Derived device state consumed by the render passes."""

    models: jnp.ndarray  # (I, 4, 4) f32
    model_inv_transpose: jnp.ndarray  # (I, 4, 4) f32
    camera: CameraPacked
    atmosphere: AtmospherePacked
    directional_lights: DirectionalLight  # stacked (2: sun, moon)
    directional_count: jnp.ndarray  # i32
    directional_skip_count: jnp.ndarray  # i32
    spot_lights: SpotLight  # stacked (MAX_SPOT, ...)
    spot_count: jnp.ndarray  # i32
    debug_segments: jnp.ndarray  # (S, 2, 3)
    debug_valid: jnp.ndarray  # (S,) bool


def _pad_rows(arr: np.ndarray, total: int, fill=0) -> np.ndarray:
    pad = total - arr.shape[0]
    if pad < 0:
        raise ValueError(f"capacity {total} < actual {arr.shape[0]}")
    if pad == 0:
        return arr
    return np.concatenate(
        [arr, np.full((pad, *arr.shape[1:]), fill, arr.dtype)], axis=0
    )


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def _renderable(scene: Scene):
    return [i for i in scene.geometry if i.mesh is not None and i.render]


def _morton3(x: np.ndarray, y: np.ndarray, z: np.ndarray) -> np.ndarray:
    """Interleave three 10-bit integer grids into a 30-bit Morton code."""

    def spread(v):
        v = v.astype(np.uint64)
        v = (v | (v << 32)) & np.uint64(0x1F00000000FFFF)
        v = (v | (v << 16)) & np.uint64(0x1F0000FF0000FF)
        v = (v | (v << 8)) & np.uint64(0x100F00F00F00F00F)
        v = (v | (v << 4)) & np.uint64(0x10C30C30C30C30C3)
        v = (v | (v << 2)) & np.uint64(0x1249249249249249)
        return v

    return spread(x) | (spread(y) << np.uint64(1)) | (spread(z) << np.uint64(2))


def _morton_order(centroids: np.ndarray) -> np.ndarray:
    """Spatial sort keys for triangle records (world-space approx).

    The raster bins triangles at CHUNK granularity with a bbox union per
    chunk (kernels/raster.py); triangles that are adjacent in
    submission order should be adjacent in space or every chunk smears over
    many tiles. Mesh-internal index order is usually local, but a scene of
    many instances interleaves them; one stable Morton sort at pack time
    (host, numpy, amortized over all frames and every shadow view) restores
    locality without any per-frame cost.
    """
    lo = centroids.min(axis=0)
    span = np.maximum(centroids.max(axis=0) - lo, 1e-6)
    q = ((centroids - lo) / span * 1023.0).astype(np.uint32)
    q = np.clip(q, 0, 1023)
    return np.argsort(
        _morton3(q[:, 0], q[:, 1], q[:, 2]), kind="stable"
    ).astype(np.int64)


def pack_geometry(
    scene: Scene,
    texture_library,
    spatial_sort: bool = True,
    mipmaps: bool = False,
    quad_pack: bool = True,
    joint_pack: bool = True,
    joint_pack_pad: bool = False,
    joint_pack_mixed: bool = False,
    atlas_f16: bool = True,
) -> GeometryStatic:
    """Flatten all renderable instances into one padded triangle soup.

    ``spatial_sort`` reorders triangle records along a world-space Morton
    curve (pack-time transforms; animation drift is fine — only locality
    matters). Rendering is order-independent except for z-ties, where
    "later submission wins" follows the sorted order.

    ``mipmaps`` packs a per-texture mip pyramid into the atlas and enables
    trilinear minification in the resolve pass (beyond-parity quality; the
    reference is single-mip).

    ``quad_pack`` stores each atlas texel's 2x2 bilinear footprint as 16
    channels so a texture sample is ONE gather; disable for
    memory-constrained atlases (4x the memory of the largest asset
    buffer) —
    sampling falls back to 4 texel gathers, identical results.

    ``joint_pack`` additionally builds a per-material 48-channel joint
    atlas when EVERY material's color/normal/orm textures share
    dimensions (single-mip + quad_pack only), so the resolve samples all
    three maps with one gather instead of three — bitwise-identical.
    ``atlas_f16`` (default ON) stores the packed atlas (and joint atlas)
    in float16; the resolve widens gathered texels to f32 before bilinear
    filtering. Texels are 8-bit-sourced (f16's ~5e-4 relative rounding
    sits below the 2e-3 quantization already present in linear light),
    and it halves the bytes through the resolve's dominant gather and the
    atlas memory. Closeness pinned by tests/test_resolve.py::test_atlas_f16_frame
    _close; False = exact f32 storage.

    ``joint_pack_pad`` (OPT-IN, off by default) extends this to
    mixed-dimension materials by upsampling the smaller maps to the
    per-axis max dims (``assets.types._upsample_repeat``): exact at fine
    texel centers, but between them the coarse bilinear kink survives —
    measured flagship-frame deviation RMSE 2.3e-3 / max 0.14 (high-
    frequency normal maps at 2x), OUTSIDE the 1e-3-RMSE parity budget, so
    it stays opt-in: a ~1-gather/px trade of fidelity for speed on
    mixed-dimension scenes (tests/test_resolve.py pins the bound).

    ``joint_pack_mixed`` builds the EXACT mixed-dimension neighborhood
    joint atlas instead (``assets.types.joint_pack_atlas_nbhd``: 108
    channels = each role's 3x3 texel neighborhood on the fine grid;
    bitwise-equal to three separate gathers when every dim ratio is a
    power of two — tests/test_resolve.py::
    test_joint_material_atlas_mixed_bitwise). Used only when the
    equal-dims 48ch joint doesn't apply; takes precedence over
    ``joint_pack_pad``. Opt-in pending device measurement (the gather is
    2.25x wider).
    """
    positions, normals, uvs, colors, vert_instance = [], [], [], [], []
    triangles, tri_material, tri_shadow, tri_centroid = [], [], [], []
    materials: list[tuple[int, int, int]] = []
    material_ids: dict[tuple[int, int, int], int] = {}

    vert_base = 0
    instance_index = 0
    for instance in _renderable(scene):
        mesh = instance.mesh
        for transform in instance.transforms:
            positions.append(mesh.positions)
            normals.append(mesh.normals)
            uvs.append(mesh.uvs)
            colors.append(mesh.colors)
            vert_instance.append(
                np.full(mesh.positions.shape[0], instance_index, np.int32)
            )
            mat4 = np.asarray(transform.to_matrix(), np.float32)
            overrides = instance.material_overrides or [None] * len(mesh.surfaces)
            for surface, override in zip(mesh.surfaces, overrides):
                material = override if override is not None else surface.material
                key = (material.color, material.normal, material.orm)
                if key not in material_ids:
                    material_ids[key] = len(materials)
                    materials.append(key)
                mat = material_ids[key]
                tris = mesh.triangles[
                    surface.first_tri : surface.first_tri + surface.tri_count
                ]
                triangles.append(tris + vert_base)
                tri_material.append(np.full(len(tris), mat, np.int32))
                tri_shadow.append(np.full(len(tris), instance.casts_shadow, bool))
                centroid = mesh.positions[tris].mean(axis=1)  # (n, 3) object
                tri_centroid.append(centroid @ mat4[:3, :3].T + mat4[:3, 3])
            vert_base += mesh.positions.shape[0]
            instance_index += 1

    if vert_base == 0:
        raise ValueError("scene has no renderable geometry")

    positions = np.concatenate(positions)
    normals = np.concatenate(normals)
    uvs = np.concatenate(uvs)
    colors = np.concatenate(colors)
    vert_instance = np.concatenate(vert_instance)
    triangles = np.concatenate(triangles).astype(np.int32)
    tri_material = np.concatenate(tri_material)
    tri_shadow = np.concatenate(tri_shadow)

    if spatial_sort and triangles.shape[0] > 1:
        order = _morton_order(np.concatenate(tri_centroid))
        triangles = triangles[order]
        tri_material = tri_material[order]
        tri_shadow = tri_shadow[order]

    v_cap = _round_up(positions.shape[0], VERTEX_PAD)
    t_cap = _round_up(triangles.shape[0], TRI_PAD)
    n_tris = triangles.shape[0]

    tri_valid = np.zeros(t_cap, bool)
    tri_valid[:n_tris] = True

    from syzygy_tpu.assets.types import (
        joint_pack_atlas,
        joint_pack_atlas_nbhd,
        quad_pack_atlas,
    )

    materials_arr = np.asarray(materials, np.int32).reshape(-1, 3)
    joint = None
    joint_dims = None
    if mipmaps:
        atlas, rects_mips = texture_library.as_atlas_mips()
        rects = rects_mips[:, 0]
        if quad_pack:
            atlas = quad_pack_atlas(atlas, rects_mips)
    else:
        atlas, rects = texture_library.as_atlas()
        rects_mips = None
        if quad_pack:
            atlas = quad_pack_atlas(atlas, rects)
            if joint_pack:
                # priority: exact 48ch (equal dims) > exact 108ch mixed
                # neighborhood > approximate pad
                joint = joint_pack_atlas(atlas, rects, materials_arr)
                if joint is None and joint_pack_mixed:
                    nb = joint_pack_atlas_nbhd(atlas, rects, materials_arr)
                    if nb is not None:
                        joint = nb[:2]
                        joint_dims = nb[2]
                if joint is None and joint_pack_pad:
                    joint = joint_pack_atlas(
                        atlas, rects, materials_arr, pad=True
                    )

    if atlas_f16:
        atlas = atlas.astype(np.float16)
        if joint is not None:
            joint = (joint[0].astype(np.float16), joint[1])

    return GeometryStatic(
        positions=jnp.asarray(_pad_rows(positions, v_cap)),
        normals=jnp.asarray(_pad_rows(normals, v_cap)),
        uvs=jnp.asarray(_pad_rows(uvs, v_cap)),
        colors=jnp.asarray(_pad_rows(colors, v_cap)),
        vert_instance=jnp.asarray(_pad_rows(vert_instance, v_cap)),
        triangles=jnp.asarray(_pad_rows(triangles, t_cap)),
        tri_material=jnp.asarray(_pad_rows(tri_material, t_cap)),
        tri_valid=jnp.asarray(tri_valid),
        tri_casts_shadow=jnp.asarray(
            _pad_rows(tri_shadow.astype(bool), t_cap, False)
        ),
        materials=jnp.asarray(materials_arr),
        tex_atlas=jnp.asarray(atlas),
        tex_rects=jnp.asarray(rects),
        tex_rects_mips=(
            jnp.asarray(rects_mips) if rects_mips is not None else None
        ),
        tex_atlas_joint=jnp.asarray(joint[0]) if joint is not None else None,
        tex_rects_joint=jnp.asarray(joint[1]) if joint is not None else None,
        tex_dims_joint=(
            jnp.asarray(joint_dims) if joint_dims is not None else None
        ),
    )


def scene_uses_metallic(scene: Scene, texture_library) -> bool:
    """Host-side static scan: does ANY used material have nonzero metallic?

    The metallic-reflection bounce (camera.comp:379-387) multiplies by the
    sampled metallic channel, so for a scene where every used ORM texture's
    metallic plane is zero the bounce contributes exactly 0 — callers may
    set ``RenderConfig.metallic_reflection=False`` (bitwise-identical
    output, ~10 fewer gathers/pixel)."""
    orm_ids = set()
    for instance in _renderable(scene):
        for mesh in [instance.mesh]:
            overrides = instance.material_overrides or [None] * len(
                mesh.surfaces
            )
            for surface, override in zip(mesh.surfaces, overrides):
                material = (
                    override if override is not None else surface.material
                )
                orm_ids.add(material.orm)
    for idx in orm_ids:
        if float(texture_library.get(idx)[..., 2].max()) > 0.0:
            return True
    return False


def pack_frame_params(
    scene: Scene, aspect_ratio: float, debug_lines: bool = False
) -> FrameParams:
    """Numpy-only per-frame snapshot (replaces staged-buffer pushes).

    ``debug_lines`` gates the wireframe-box segment packing (it walks every
    instance transform; only pay for it when the overlay is on)."""
    # SoA fast path: one block per instance (flat in transform count; the
    # per-object list walk was the host bottleneck past ~10k instances)
    renderable = _renderable(scene)
    if renderable:
        translations = np.concatenate([i.translations for i in renderable])
        eulers = np.concatenate([i.eulers for i in renderable])
        scales = np.concatenate([i.scales for i in renderable])
    else:
        translations = np.zeros((1, 3), np.float32)
        eulers = np.zeros((1, 3), np.float32)
        scales = np.ones((1, 3), np.float32)

    bounds_min, bounds_max = scene.shadow_bounds()
    spots, spot_count = spot_raw(
        scene.spotlights if scene.spotlights_render else [], MAX_SPOT_LIGHTS
    )
    if debug_lines:
        debug_segments, debug_valid = _debug_boxes(scene, bounds_min, bounds_max)
    else:
        debug_segments = np.zeros((1, 2, 3), np.float32)
        debug_valid = np.zeros(1, bool)
    f = np.float32
    return FrameParams(
        translations=np.asarray(translations, np.float32),
        euler_angles=np.asarray(eulers, np.float32),
        scales=np.asarray(scales, np.float32),
        cam_position=np.asarray(scene.camera.position, np.float32),
        cam_euler_angles=np.asarray(scene.camera.euler_angles, np.float32),
        cam_fov_degrees=f(scene.camera.fov_degrees),
        cam_near=f(scene.camera.near),
        cam_far=f(scene.camera.far),
        aspect_ratio=f(aspect_ratio),
        atmosphere=atmosphere_raw(scene.atmosphere),
        bounds_min=np.asarray(bounds_min, np.float32),
        bounds_max=np.asarray(bounds_max, np.float32),
        spots=spots,
        spot_count=np.int32(spot_count),
        directional_skip_count=np.int32(1 if scene.render_atmosphere else 0),
        debug_segments=debug_segments,
        debug_valid=debug_valid,
    )


_BOX_EDGES = np.array(
    [
        [0, 1], [1, 3], [3, 2], [2, 0],
        [4, 5], [5, 7], [7, 6], [6, 4],
        [0, 4], [1, 5], [2, 6], [3, 7],
    ],
    np.int32,
)


def _debug_boxes(scene: Scene, bounds_min, bounds_max):
    """Wireframe boxes: per-instance oriented mesh bounds + scene shadow
    bounds (``renderer.cpp:344-366, 417-427``). Fixed capacity per scene."""
    segs = []
    for instance in _renderable(scene):
        vmin, vmax = instance.mesh.vertex_bounds
        corners = np.array(
            [
                [x, y, z]
                for x in (vmin[0], vmax[0])
                for y in (vmin[1], vmax[1])
                for z in (vmin[2], vmax[2])
            ],
            np.float32,
        )
        corners_h = np.concatenate([corners, np.ones((8, 1), np.float32)], 1)
        for t in instance.transforms:
            world = (t.to_matrix() @ corners_h.T).T[:, :3]
            segs.append(world[_BOX_EDGES])
    # scene shadow bounds box (axis aligned)
    bmin = np.asarray(bounds_min, np.float32)
    bmax = np.asarray(bounds_max, np.float32)
    corners = np.array(
        [
            [x, y, z]
            for x in (bmin[0], bmax[0])
            for y in (bmin[1], bmax[1])
            for z in (bmin[2], bmax[2])
        ],
        np.float32,
    )
    segs.append(corners[_BOX_EDGES])
    segments = np.concatenate(segs, axis=0).astype(np.float32)
    valid = np.ones(segments.shape[0], bool)
    return segments, valid


class FrameParamSpec(NamedTuple):
    """Static description of a flattened FrameParams buffer (hashable)."""

    shapes: tuple  # tuple of leaf shapes, flatten order of jax.tree
    dtypes: tuple  # tuple of dtype names
    offsets: tuple  # element offsets into the f32 buffer
    total: int  # total f32 elements


def frame_param_spec(params: FrameParams) -> FrameParamSpec:
    import jax

    leaves = jax.tree.leaves(params)
    shapes, dtypes, offsets = [], [], []
    offset = 0
    for leaf in leaves:
        arr = np.asarray(leaf)
        shapes.append(tuple(arr.shape))
        dtypes.append(arr.dtype.name)
        offsets.append(offset)
        offset += int(arr.size)
    return FrameParamSpec(
        shapes=tuple(shapes),
        dtypes=tuple(dtypes),
        offsets=tuple(offsets),
        total=offset,
    )


def flatten_frame_params(
    params: FrameParams, spec: FrameParamSpec, out: np.ndarray | None = None
) -> np.ndarray:
    """Pack every leaf into ONE f32 numpy buffer (one H2D per frame instead
    of ~45 — the per-array upload overhead dominates on remote devices).
    Integer/bool leaves are stored as f32 (all are small counts/flags)."""
    import jax

    buf = out if out is not None else np.empty(spec.total, np.float32)
    for leaf, off in zip(jax.tree.leaves(params), spec.offsets):
        arr = np.asarray(leaf)
        buf[off : off + arr.size] = arr.astype(np.float32).reshape(-1)
    return buf


def unflatten_frame_params(spec: FrameParamSpec, buffer) -> FrameParams:
    """Device-side inverse of :func:`flatten_frame_params` (runs under jit)."""
    import jax

    dummy = FrameParams(*[0] * len(FrameParams._fields))._replace(
        atmosphere=AtmosphereRaw(*[0] * len(AtmosphereRaw._fields)),
        spots=SpotRaw(*[0] * len(SpotRaw._fields)),
    )
    treedef = jax.tree.structure(dummy)
    leaves = []
    for shape, dtype, off in zip(spec.shapes, spec.dtypes, spec.offsets):
        size = int(np.prod(shape)) if shape else 1
        leaf = jax.lax.dynamic_slice(buffer, (off,), (size,)).reshape(shape)
        if dtype != "float32":
            leaf = leaf.astype(dtype)
        leaves.append(leaf)
    return jax.tree.unflatten(treedef, leaves)


def prepare_frame_state(params: FrameParams) -> FrameState:
    """Device-side derivation of all per-frame matrices (runs under jit)."""
    # Model matrices: T @ R @ S batched over instances (Transform::toMatrix)
    rot = orientate4(params.euler_angles)  # (I, 4, 4)
    scales4 = jnp.concatenate(
        [params.scales, jnp.ones((*params.scales.shape[:-1], 1), jnp.float32)],
        axis=-1,
    )
    models = rot * scales4[..., None, :]  # scale columns
    models = models.at[..., 0:3, 3].set(params.translations)
    inv_t = inverse4(models).transpose(0, 2, 1)

    camera = pack_camera(
        params.cam_position,
        params.cam_euler_angles,
        params.cam_fov_degrees,
        params.cam_near,
        params.cam_far,
        params.aspect_ratio,
    )
    atmosphere = pack_atmosphere(params.atmosphere)
    directional = bake_directional(
        params.atmosphere, params.bounds_min, params.bounds_max
    )
    spot_lights = make_spot_batched(params.spots)
    return FrameState(
        models=models,
        model_inv_transpose=inv_t,
        camera=camera,
        atmosphere=atmosphere,
        directional_lights=directional,
        directional_count=jnp.asarray(2, jnp.int32),
        directional_skip_count=jnp.asarray(
            params.directional_skip_count, jnp.int32
        ),
        spot_lights=spot_lights,
        spot_count=jnp.asarray(params.spot_count, jnp.int32),
        debug_segments=jnp.asarray(params.debug_segments, jnp.float32),
        debug_valid=jnp.asarray(params.debug_valid),
    )

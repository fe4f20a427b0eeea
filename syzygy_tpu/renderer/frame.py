"""The frame graph: scene state to final image.

The equivalent of ``Renderer::recordDraw`` (``renderer/renderer.cpp:278-443``)
+ ``DeferredShadingPipeline::recordDrawCommands`` (``deferred.cpp:435-792``)
+ ``SkyViewComputePipeline::recordDrawCommands`` (``skyview.cpp:751-911``)
+ the OETF dispatch (``editor/editor.cpp:303-340``). Vulkan's command buffer,
barriers and image layout transitions collapse into XLA dataflow.

The single-device path (:func:`render_frame`) chains jitted stages —
geometry (vertex/shadow/raster/resolve records), then lighting+sky+OETF —
instead of one mega-program: intermediates stay on device and the host never
syncs between them (the analog of one queue submission), and each program
keeps XLA compile time bounded.

The multi-device path uses :func:`render_frame_rows` (the whole pipeline as a
pure function over a row block) under ``shard_map`` — see
``syzygy_tpu.parallel``.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp

from syzygy_tpu.kernels.atmosphere import (
    METERS_PER_MM,
    compute_skyview_lut,
    compute_transmittance_lut,
    pack_lut,
)
from syzygy_tpu.kernels.common import cdiv as cdiv_static, match_vma, round_up
from syzygy_tpu.kernels.lighting import deferred_lighting
from syzygy_tpu.kernels.raster import (
    TILE_H,
    TILE_W,
    rasterize,
    setup_triangles,
)
from syzygy_tpu.kernels.resolve import (
    resolve_gbuffer,
    transform_normals,
    transform_positions,
)
from syzygy_tpu.kernels.sky import sky_camera_pass
from syzygy_tpu.kernels.transfer import oetf_pure_gamma, oetf_srgb
from syzygy_tpu.scene.lights import MAX_SPOT_LIGHTS
from syzygy_tpu.scene.pack import (
    FrameParams,
    FrameState,
    GeometryStatic,
    prepare_frame_state,
    unflatten_frame_params,
)

N_DIRECTIONAL = 2  # sun + moon (renderer.cpp:311-328)


def _sky_chunks(h: int, override: int) -> int:
    """Row chunks for the fused resolve+lighting+sky program (``lax.map``
    over row blocks). ``override`` must divide the padded height ``h``;
    0 = auto: one block, which measured faster than 68-row chunks on the
    H100 at 1080p (PERF.md)."""
    if override:
        if h % override != 0:
            raise ValueError(
                f"sky_row_chunks={override} does not divide height {h}"
            )
        return override
    return 1


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static frame configuration (hashable: used as a jit static arg).

    Counterpart of the reference's compile-time constants + UI config
    (``editor/editorconfig.hpp``, ``deferred.hpp:108-118``).
    """

    width: int = 1920
    height: int = 1080
    shadow_dim: int = 1024  # ref: 8192 (deferred.cpp:179); scaled down
    # shadow-map raster budget: sun, moon, then spots in order — capacity 10
    # matches the reference's ShadowPassArray (deferred.cpp:179-180,
    # shadowpass.hpp:36); lights beyond it get no shadow (the reference warns
    # on overflow, shadowpass.cpp:219-225). Scenes with few lights can lower
    # this to skip the per-light triangle setup work.
    n_shadow_maps: int = 10
    # shadow depth bias, Vulkan vkCmdSetDepthBias semantics (constant * r +
    # slope * max|dz/dxy| added to occluder depth; r = 2^-23 for D32).
    # Reference: ShadowPassParameters{depthBiasConstant=0, depthBiasSlope=0}
    # (shadowpass.hpp:26-27), applied at pipelines.cpp:716 and UI-tunable
    # (engineui.cpp:151-161). Note reverse-Z: push occluders AWAY from the
    # light with NEGATIVE bias. Defaults 0 keep rasters bitwise unchanged.
    shadow_bias_constant: float = 0.0
    shadow_bias_slope: float = 0.0
    # skyview LUT dims; reference 2048x1024 (skyview.cpp:175). Smaller
    # LUTs stay inside the 1e-3 parity budget (768x384 lands at frame RMSE
    # 2.6e-4 on CPU); the default stays at reference parity.
    skyview_width: int = 2048  # skyview.cpp:175
    skyview_height: int = 1024
    # transmittance LUT dims; reference 512x128 (common.glinl:13). The
    # field is smooth, so downsampling is closeness-bounded
    # (test_transmittance_lut_downsample_close). Half-texel insets follow
    # the dims (samplers derive them from the LUT object), so any dims are
    # self-consistent.
    transmittance_width: int = 512
    transmittance_height: int = 128
    # PCF tap extraction variant (kernels/lighting.py::sample_shadow_map):
    # False = per-tap binary select tree (default), True = per-row compare
    # bitmask + variable-shift extraction. Bitwise-identical results; OFF
    # by default, not measured on the H100.
    pcf_bitmask: bool = False
    # store the PCF segment tables in f16 (kernels/lighting.py::
    # sample_shadow_map): halves the bytes through the row gathers and the
    # select trees. Storage-precision-only fast mode (occluder depths round
    # to ~5e-4 relative before the reverse-Z compare; a tap flips only when
    # the occluder-receiver gap is below that); quality pinned by
    # tests/test_lighting.py::test_pcf_f16_{close,frame_close}. False =
    # exact f32 storage. ON by default; its cost on the H100 is not
    # measured yet.
    pcf_f16: bool = True
    # u8 block-scaled PCF segment tables (takes precedence over pcf_f16):
    # 20 B/row vs f16's 32, taps quantized to u8 fractions of each
    # segment's own depth range (error <= range/510; exact zeros stay exact
    # so the border test is preserved). Quality pinned by
    # tests/test_lighting.py::test_pcf_q8_{close,frame_close}. OFF by
    # default, not measured on the H100.
    pcf_q8: bool = False
    # One-gather 2D-window PCF (kernels/lighting.py::_pcf_window2d;
    # ignored under pcf_q8): 8-row x 16-col window blocks at row stride 2
    # replace the five per-tap-row segment gathers with ONE 128-channel
    # gather per pixel. Taps are BITWISE-identical (tests/test_lighting.py
    # ::test_pcf_window2d_bitwise). OFF by default, not measured on the
    # H100.
    pcf_window2d: bool = False
    # Dim-directional shadow skip (the midday-moon fast mode): a
    # directional light whose peak spectral intensity max|color|*|strength|
    # is below eps RELATIVE to the frame's total daylight-weighted
    # directional intensity (incl. the sky-handled sun — see
    # kernels/lighting.py::deferred_lighting) contributes UNSHADOWED
    # (a separate PCF-free loop skips its whole 5x5 PCF structurally)
    # and its shadow-map raster is skipped. The reference's
    # clamp-transposition quirk (scene.cpp:603-610) keeps the moon active
    # in full daylight at peak intensity 0.012, paying a full PCF
    # evaluation + a depth raster for a ~1% contribution; the RELATIVE gate
    # keeps the night moon (the only light, ratio 1) exactly shadowed.
    # Deviation bounded by tests/test_lighting.py::
    # test_shadowless_eps_frame_close (default scene RMSE 5.3e-5 / max
    # 4.2e-4; chess flagship RMSE 1.9e-5 / max 1.8e-3 on 0.01% of pixels,
    # CPU renders at 960x540 — far inside the 1e-3 RMSE parity budget), so
    # ON by default like the other parity-bounded fast modes. 0.0 = exact
    # (still skips rasters for EXACTLY-zero directionals, which is
    # frame-bitwise: their maps are never sampled). Map 0 (sun) always
    # rasters — the sky pass samples it.
    shadowless_strength_eps: float = 0.025
    # Share ONE sun PCF evaluation between the lighting loop and the sky
    # camera pass. Both evaluate the IDENTICAL per-pixel chain
    # sample_shadow_map(compute_shadow_frame(sun_pv, material.position,
    # material.normal)) — lighting for directional light 0's shadow factor
    # (lights.comp:52-60), sky for the sun-disk/reflection visibility
    # (camera.comp:349-356) — but as differently-shaped programs XLA
    # cannot CSE them. compute_shadow_frame's spread is analytic per-pixel
    # (no screen-space derivatives), so hoisting it once computes the
    # identical math; frames agree to XLA fusion/reassociation noise
    # (tests/test_lighting.py::test_share_sun_pcf_bitwise). OFF by
    # default, not measured on the H100.
    share_sun_pcf: bool = False
    # store the skyview quad in f16 (sampled values widen back to f32
    # before filtering). Storage-precision-only fast mode (~5e-4
    # relative); bounded by tests/test_sky.py::test_skyview_f16_frame_close
    # (frame RMSE <2e-4). False = exact f32 storage (bitwise reference
    # formulas).
    skyview_f16: bool = True
    # u8 block-scaled skyview quad (kernels/atmosphere.py::PackedLUTQ8):
    # 16 B/row vs the f16 quad's 24 B on the frame's biggest table. Takes
    # precedence over skyview_f16. Quantization is blockwise-relative (u8
    # fractions of the 2x2 footprint's own max; error <= local_max/510);
    # quality pinned by tests/test_sky.py::test_skyview_q8_frame_close.
    # ON by default; its cost on the H100 is not measured yet.
    skyview_q8: bool = True
    # narrow the small per-pixel sky tables (transmittance quad sampling
    # copy + froxel volume) to f16 the same way. OFF by default, not
    # measured on the H100; quality bound (if enabled) pinned by
    # tests/test_sky.py::test_lut_f16_frame_close.
    lut_f16: bool = False
    render_atmosphere: bool = True
    debug_lines: bool = False  # wireframe bounds overlay (debuglines.hpp)
    oetf: str = "srgb"  # GammaTransferFunction (editorconfig.hpp:5-9)
    # supersampling factor (beyond-reference AA): render at width*ss and
    # box-filter down before the OETF
    supersample: int = 1
    # row chunking of the resolve+lighting+sky program (0 = auto, see
    # _sky_chunks): the pass runs as lax.map over this many row blocks.
    # Per-pixel math is unchanged (differences stay at XLA
    # fusion/reassociation noise, observed <= ~2e-5).
    sky_row_chunks: int = 0
    # fast in-scattering integral (Hillaire production accumulation, 1 LUT
    # gather/step instead of 5 — kernels/atmosphere.py). Opt-in speed mode:
    # deviates from the reference's LUT-ratio variant by up to ~1e-2 in sky
    # luminance (32 samples make each step span tens of km). Default False
    # keeps the quirk-exact integral.
    fast_sky: bool = False
    # aerial-perspective froxel LUT mode (kernels/sky.py::build_aerial_lut):
    # replaces every per-pixel 32-step in-scattering march with LUT
    # lookups — geometry rays trilinear-sample a 32x32x16 frustum volume
    # built with the EXACT reference integral, environment ground rays and
    # the metallic bounce reuse the skyview LUT. Production Hillaire
    # technique; whole-frame deviation vs the per-pixel integral: RMSE
    # ~1.5e-4 against the 1e-3 RMSE parity budget (max deviation ~7.5e-3,
    # inside the tests' 2e-2 max bound), flagship + default scenes — so ON
    # by default. False = quirk-exact per-pixel 32-step integral.
    aerial_lut: bool = True
    # Froxel volume far plane (meters). Geometry BEYOND this distance
    # clamps to the last slice: its in-scatter and path transmittance stop
    # growing, so scenes with visible surfaces much farther than this
    # deviate past the parity budget — raise it (cost is unchanged; slice
    # spacing is quadratic) or set aerial_lut=False for such scenes.
    aerial_lut_far_m: float = 4000.0
    # The env branch's camera->ground segment transmittance from a tiny
    # per-frame row table (kernels.sky.compute_skyview_tseg +
    # pack_tseg_rows): t_seg along a ground-hitting camera ray depends only
    # on elevation — the skyview v axis — so a (skyview_height, 6) packed
    # table sampled at the skyview v replaces the branch's 2-gather
    # per-pixel segment sample with ONE small gather (aerial_lut mode
    # only). Closeness-bounded fast mode (the v-row table is interpolated):
    # whole-frame RMSE vs the exact per-pixel segment sample is far inside
    # the 1e-3 parity budget (tests/test_sky.py); False = exact.
    skyview_tseg: bool = True
    # metallic-reflection environment bounce (camera.comp:379-387). When a
    # scene provably contains no metallic material the bounce multiplies to
    # exactly zero, so skipping it is bitwise-identical and saves ~10
    # gathers/pixel — scene_uses_metallic(scene, library) gives callers the
    # static answer (app auto-sets this).
    metallic_reflection: bool = True
    # Merge the lighting stage into the sky program (2 chained device
    # programs per frame instead of 3). Identical math — only the program
    # partitioning changes; equivalence pinned by
    # tests/test_lighting.py::test_fused_lighting_sky_matches.
    fuse_lighting_sky: bool = True
    # Run the LIGHTING pass inside the sky pass's row-chunk lax.map (one
    # merged per-chunk body) instead of as a separate full-frame phase.
    # Identical per-pixel math — lighting is purely per-pixel — differing
    # only by XLA fusion/reassociation noise. Requires render_atmosphere;
    # implies the 2-program frame.
    fuse_lighting_sky_chunks: bool = True
    # Also run the G-BUFFER RESOLVE per row chunk inside the lighting+sky
    # program (requires fuse_lighting_sky_chunks semantics; single-mip
    # path only — the mip path's LOD derivatives are cross-pixel). The
    # geometry program then stops at the visibility buffer + pre-joined
    # records, and the 5-plane G-buffer never materializes in device
    # memory. Identical per-pixel math (XLA reassociation noise only).
    # Ignored when mips are enabled or render_atmosphere is off.
    resolve_in_sky_chunks: bool = True
    # fast integral for the metallic-reflection environment bounce only
    # (camera.comp:379-387). The bounce's aerial term is second-order
    # (scaled by metallic * fresnel * segment transmittance): measured
    # whole-frame deviation <= 1e-6 on the flagship scene, exactly 0 for
    # metallic-free scenes — far inside the 1e-3 parity budget — while
    # removing one full 32-step LUT-ratio integral per pixel.
    fast_sky_reflection: bool = True
    # Multi-device only: shard the camera raster's O(T) triangle-setup slot
    # math (corner gather + clip fan + coefficient build) over the sp mesh
    # axis and rejoin via all_gather, instead of every device repeating the
    # full-scene setup (kernels/raster.py::setup_triangles shard_axis).
    # Exact (slot order preserved; T pads to a device multiple with invalid
    # slots). No effect on one device.
    shard_triangle_setup: bool = True

    @property
    def render_width(self) -> int:
        return self.width * self.supersample

    @property
    def render_height(self) -> int:
        return self.height * self.supersample

    @property
    def padded_width(self) -> int:
        return round_up(self.render_width, TILE_W)

    @property
    def padded_height(self) -> int:
        return round_up(self.render_height, TILE_H)


def _shadow_pass(
    geometry: GeometryStatic,
    world_h: jnp.ndarray,  # (V, 4) world positions (homogeneous)
    state: FrameState,
    config: RenderConfig,
    shard_axis: str | None = None,
) -> jnp.ndarray:
    """Depth-only raster per shadow-casting light, vmapped over the light axis
    (``ShadowPassArray::recordDrawCommands`` + ``OffscreenPassGraphicsPipeline``,
    ``pipelines.cpp:593-806``: front-face culling, reverse-Z).

    With ``shard_axis`` (inside shard_map) the lights are partitioned across
    the named mesh axis — light parallelism — and the maps rejoin through an
    ``all_gather`` over ICI, instead of every device rastering every light.
    """
    dim = config.shadow_dim
    n_maps = config.n_shadow_maps

    # light projView stack: [sun, moon, spots...]
    dir_pv = jnp.einsum(
        "lij,ljk->lik",
        state.directional_lights.projection,
        state.directional_lights.view,
    )
    spot_pv = jnp.einsum(
        "lij,ljk->lik", state.spot_lights.projection, state.spot_lights.view
    )
    pv = jnp.concatenate([dir_pv, spot_pv], axis=0)[:n_maps]  # (L, 4, 4)

    light_index = jnp.arange(n_maps)
    active = light_index < (N_DIRECTIONAL + state.spot_count)

    # Skip rasters for maps nothing will sample: directional slots whose
    # light cannot contribute (emits == 0 — frame-bitwise: the lighting
    # loop skips them too) and, under the shadowless fast mode
    # (RenderConfig.shadowless_strength_eps), dim directionals that light
    # unshadowed. Map 0 (sun) always rasters: the sky pass samples it
    # regardless of the lighting loop (kernels/sky.py sun PCF). Spots are
    # never gated.
    d = state.directional_lights
    dir_int = jnp.max(jnp.abs(d.color[:, :3]), axis=-1) * jnp.abs(d.strength)
    eps = config.shadowless_strength_eps
    if eps > 0.0:
        # same relative gate as deferred_lighting (kernels/lighting.py)
        from syzygy_tpu.math.geometry import WORLD_UP

        daylight = jnp.clip(
            jnp.sum(-d.forward[:, :3] * WORLD_UP, axis=-1), 0.0, 1.0
        )
        dir_needs = dir_int >= eps * jnp.sum(dir_int * daylight)
    else:
        dir_needs = dir_int != 0.0
    dir_needs = dir_needs.at[0].set(True)
    needs = jnp.concatenate(
        [
            dir_needs[:n_maps],
            jnp.ones(max(0, n_maps - N_DIRECTIONAL), bool),
        ]
    )
    active = active & needs

    tri_valid = geometry.tri_valid & geometry.tri_casts_shadow

    # Gather world-space triangle corners ONCE; each light only pays a
    # (T, 3, 4) @ (4, 4) transform instead of re-gathering 2T vertex rows
    # per raster.
    corners_world = world_h[geometry.triangles]  # (T, 3, 4)

    def one_light(light_pv, is_active):
        corner_clip = jnp.einsum("tcj,ij->tci", corners_world, light_pv)
        setup = setup_triangles(
            None,
            geometry.triangles,
            tri_valid & is_active,
            dim,
            dim,
            cull_keep_sign=-1,  # front-face culling (pipelines.cpp:654-663)
            corner_clip=corner_clip,
            depth_bias_constant=config.shadow_bias_constant,
            depth_bias_slope=config.shadow_bias_slope,
        )
        return rasterize(setup, dim, dim, depth_only=True).depth

    # Sequential per-light rasters rather than vmap: each light's triangle
    # setup is O(T) temporary memory, and 18 concurrent copies OOM at ~250k
    # triangles. Single-chip path: dynamic-trip-count loop so only ACTIVE
    # lights raster (an n_shadow_maps=10 config with 3 live lights skips 7
    # setup+grid passes; inactive slots keep the zero map, identical to an
    # empty raster).
    if shard_axis is not None and jax.lax.axis_size(shard_axis) > 1:
        # Light parallelism over ACTIVE lights: compact the live lights
        # first (stable order, like the single-chip loop), partition the
        # compacted range across devices, and raster each device's share
        # with a dynamic-trip-count loop — a device whose share is empty
        # rasters NOTHING (the old slot partition ran a full raster grid
        # for every one of the n_maps slots, active or not: ~10 grids at
        # sp=1 where the single-chip path runs ~2).
        n_dev = jax.lax.axis_size(shard_axis)
        my = jax.lax.axis_index(shard_axis)
        per_dev = cdiv_static(n_maps, n_dev)
        order = jnp.argsort(~active, stable=True).astype(jnp.int32)
        n_active = jnp.sum(active.astype(jnp.int32))

        def raster_one(k, maps):
            i = order[my * per_dev + k]
            depth = one_light(pv[i], jnp.bool_(True))
            return jax.lax.dynamic_update_slice(maps, depth[None], (k, 0, 0))

        count = jnp.clip(n_active - my * per_dev, 0, per_dev)
        local = jax.lax.fori_loop(
            0,
            count,
            raster_one,
            match_vma(
                jnp.zeros((per_dev, dim, dim), jnp.float32), pv, active, my
            ),
        )
        gathered = jax.lax.all_gather(local, shard_axis)  # (n_dev, per_dev, ...)
        flat = gathered.reshape(n_dev * per_dev, dim, dim)
        # scatter compacted results back to their light slots; inactive
        # slots receive flat's zero rows (identical to an empty raster)
        maps = (
            match_vma(jnp.zeros((n_maps, dim, dim), jnp.float32), flat)
            .at[order]
            .set(flat[:n_maps])
        )
    else:
        # Compact to the maps that raster (stable order preserved):
        # inactive / skipped slots keep the zero map.
        order = jnp.argsort(~active, stable=True).astype(jnp.int32)

        def raster_one(k, maps):
            i = order[k]
            depth = one_light(pv[i], jnp.bool_(True))
            return jax.lax.dynamic_update_slice(
                maps, depth[None], (i, 0, 0)
            )

        maps = jax.lax.fori_loop(
            0,
            jnp.sum(active.astype(jnp.int32)),
            raster_one,
            match_vma(
                jnp.zeros((n_maps, dim, dim), jnp.float32), pv, active
            ),
        )
    total_lights = N_DIRECTIONAL + MAX_SPOT_LIGHTS
    if maps.shape[0] < total_lights:
        maps = jnp.concatenate(
            [
                maps,
                jnp.zeros(
                    (total_lights - maps.shape[0], dim, dim), jnp.float32
                ),
            ],
            axis=0,
        )
    return maps


# ---------------------------------------------------------------------------
# staged single-chip path
# ---------------------------------------------------------------------------


def _defers_resolve(config: RenderConfig, geometry: GeometryStatic) -> bool:
    """True when the geometry stage hands over pre-joined per-triangle
    records (resolve deferred into the lighting+sky row chunks) instead of
    a resolved G-buffer. Single place for the condition — the single-chip
    and sharded paths MUST agree on it."""
    return (
        config.resolve_in_sky_chunks
        and config.render_atmosphere
        and geometry.tex_rects_mips is None
    )


def _geometry_body(
    geometry: GeometryStatic,
    params: FrameParams,
    config: RenderConfig,
    row0=0,
    local_rows: int | None = None,
    shadow_shard_axis: str | None = None,
):
    """prepare + vertex + shadow rasters + camera raster + G-buffer resolve.

    Shared by the jitted single-chip stage (:func:`_stage_geometry`) and the
    sharded row path (:func:`render_frame_rows`) — ``row0`` may be traced,
    and ``shadow_shard_axis`` partitions the shadow rasters across a mesh
    axis (light parallelism, rejoined via ``all_gather``); the same axis
    shards the camera setup's O(T) slot math when
    ``config.shard_triangle_setup``."""
    local_rows = config.padded_height if local_rows is None else local_rows
    state = prepare_frame_state(params)
    proj_view = state.camera.projection @ state.camera.view
    clip, world = transform_positions(
        geometry.positions, geometry.vert_instance, state.models, proj_view
    )
    world_normals = transform_normals(
        geometry.normals, geometry.vert_instance, state.model_inv_transpose
    )
    world_h = jnp.concatenate(
        [world, jnp.ones((world.shape[0], 1), jnp.float32)], axis=-1
    )
    shadow_maps = _shadow_pass(
        geometry, world_h, state, config, shard_axis=shadow_shard_axis
    )

    setup = setup_triangles(
        clip,
        geometry.triangles,
        geometry.tri_valid,
        config.render_width,
        config.render_height,
        cull_keep_sign=+1,  # back-face cull, CW front (deferred.cpp:503-713)
        shard_axis=(
            shadow_shard_axis if config.shard_triangle_setup else None
        ),
    )
    vis = rasterize(
        setup, config.padded_width, local_rows,
        origin=jnp.stack(
            [jnp.asarray(row0, jnp.int32), jnp.int32(0)]
        ),
    )
    if _defers_resolve(config, geometry):
        # defer the per-pixel resolve to the lighting+sky program's row
        # chunks; hand over the pre-joined records instead of a G-buffer
        from syzygy_tpu.kernels.resolve import build_resolve_records

        records = build_resolve_records(
            setup, geometry, world, world_normals,
            shard_axis=(
                shadow_shard_axis if config.shard_triangle_setup else None
            ),
        )
        return state, vis, records, shadow_maps
    gbuffer = resolve_gbuffer(vis, setup, geometry, world, world_normals)
    return state, vis, gbuffer, shadow_maps


@functools.partial(jax.jit, static_argnames=("config", "row0", "local_rows"))
def _stage_geometry(
    geometry: GeometryStatic,
    params: FrameParams,
    config: RenderConfig,
    row0: int = 0,
    local_rows: int | None = None,
):
    """Jitted single-chip geometry stage (see :func:`_geometry_body`)."""
    return _geometry_body(geometry, params, config, row0, local_rows)


def _sun_pcf(state, gbuffer, shadow_maps, config):
    """The shared sun PCF visibility (RenderConfig.share_sun_pcf): the
    exact (H, W) chain both deferred_lighting (light 0) and
    sky_camera_pass evaluate internally, hoisted so the frame pays its 5
    row gathers + select trees once."""
    from syzygy_tpu.kernels.lighting import (
        compute_shadow_frame,
        convert_pbr,
        sample_shadow_map,
    )

    material = convert_pbr(gbuffer)
    sun = jax.tree.map(lambda x: x[0], state.directional_lights)
    coord, dx, dy = compute_shadow_frame(
        sun.projection @ sun.view, material.position, material.normal
    )
    return sample_shadow_map(
        shadow_maps[0],
        coord,
        dx,
        dy,
        bitmask=config.pcf_bitmask,
        f16=config.pcf_f16,
        q8=config.pcf_q8,
        window2d=config.pcf_window2d,
    )


@functools.partial(
    jax.jit,
    static_argnames=("pcf_bitmask", "pcf_f16", "pcf_q8", "pcf_window2d"),
)
def _stage_sun_pcf(
    state, gbuffer, shadow_maps, pcf_bitmask=False, pcf_f16=False,
    pcf_q8=False, pcf_window2d=False,
):
    """share_sun_pcf in the UNFUSED 3-program frame: the hoisted sun PCF
    runs as its own chained device program whose (H, W) output feeds both
    neighbors."""
    cfg = dataclasses.replace(
        RenderConfig(), pcf_bitmask=pcf_bitmask, pcf_f16=pcf_f16,
        pcf_q8=pcf_q8, pcf_window2d=pcf_window2d,
    )
    return _sun_pcf(state, gbuffer, shadow_maps, cfg)


@functools.partial(
    jax.jit,
    static_argnames=(
        "pcf_bitmask", "pcf_f16", "pcf_q8", "shadowless_eps", "pcf_window2d"
    ),
)
def _stage_lighting(
    state: FrameState, gbuffer, shadow_maps, pcf_bitmask=False, pcf_f16=False,
    pcf_q8=False, shadowless_eps=0.0, sun_shadow=None, pcf_window2d=False,
):
    """deferred lighting (lights.comp); scene color clamps like UNORM."""
    lit = deferred_lighting(
        gbuffer,
        state.camera,
        state.directional_lights,
        state.directional_count,
        state.directional_skip_count,
        state.spot_lights,
        state.spot_count,
        shadow_maps,
        pcf_bitmask=pcf_bitmask,
        pcf_f16=pcf_f16,
        pcf_q8=pcf_q8,
        pcf_window2d=pcf_window2d,
        shadowless_eps=shadowless_eps,
        sun_shadow=sun_shadow,
    )
    return jnp.clip(lit, 0.0, 1.0)


@functools.partial(jax.jit, static_argnames=("config", "row0"))
def _stage_sky(
    state: FrameState,
    lit,
    vis_depth,
    gbuffer,
    shadow_maps,
    config: RenderConfig,
    row0: int = 0,
    sun_shadow=None,
    # resolve_in_sky_chunks: the G-buffer is computed HERE per row chunk
    # from the visibility buffer + pre-joined records (gbuffer arg is
    # None); geometry supplies the texture atlas tables.
    vis_full=None,
    records=None,
    geometry=None,
):
    """atmosphere LUTs + per-pixel sky pass + OETF."""
    if config.render_atmosphere:
        # quad-pack once per frame: every downstream bilinear sample of the
        # transmittance LUT becomes ONE gather (kernels/atmosphere.py)
        t_lut = pack_lut(
            compute_transmittance_lut(
                state.atmosphere,
                width=config.transmittance_width,
                height=config.transmittance_height,
            )
        )
        origin_mm = state.camera.position[:3] / METERS_PER_MM
        origin_mm = origin_mm * jnp.array([1.0, -1.0, 1.0], jnp.float32)
        origin_mm = origin_mm + jnp.array(
            [0.0, state.atmosphere.planet_radius_mm, 0.0], jnp.float32
        )
        sky_arr = compute_skyview_lut(
            state.atmosphere,
            origin_mm,
            t_lut,
            width=config.skyview_width,
            height=config.skyview_height,
            fast=config.fast_sky,
        )
        tseg_packed = None
        if config.aerial_lut and config.skyview_tseg:
            from syzygy_tpu.kernels.sky import (
                compute_skyview_tseg,
                pack_tseg_rows,
            )

            tseg_packed = pack_tseg_rows(
                compute_skyview_tseg(
                    state.atmosphere, t_lut, origin_mm, config.skyview_height
                )
            )  # (h, 6): u-invariant rows; ONE tiny-table gather per pixel
        if config.skyview_q8:
            from syzygy_tpu.kernels.atmosphere import pack_lut_q8

            sky_lut = pack_lut_q8(sky_arr)
        else:
            sky_lut = pack_lut(
                sky_arr, dtype=jnp.float16 if config.skyview_f16 else None
            )
        sun = jax.tree.map(lambda x: x[0], state.directional_lights)

        aerial = None
        t_max_mm = config.aerial_lut_far_m / METERS_PER_MM
        if config.aerial_lut:
            from syzygy_tpu.kernels.sky import build_aerial_lut

            aerial = build_aerial_lut(
                state.atmosphere, t_lut, state.camera, origin_mm, t_max_mm
            )

        # Per-pixel sampling copies (lut_f16): the f32 originals above fed
        # every build; the camera pass's per-pixel gathers ride half the
        # bytes. PackedLUT/AerialLUT samplers widen to f32 after the gather.
        t_lut_px = t_lut
        if config.lut_f16:
            from syzygy_tpu.kernels.atmosphere import PackedLUT

            t_lut_px = PackedLUT(
                t_lut.quad.astype(jnp.float16), t_lut.h, t_lut.w
            )
            if aerial is not None:
                aerial = type(aerial)(
                    aerial.packed.astype(jnp.float16),
                    aerial.t_sun0,
                    aerial.n_y,
                    aerial.n_x,
                    aerial.n_s,
                )

        def lit_of(gb_c, ss_c=None):
            # fuse_lighting_sky_chunks: the whole lighting pass runs on
            # THIS row chunk, inside the sky's lax.map — its PCF gathers
            # then co-schedule with the chunk's in-scatter integral
            # compute instead of forming a separate phase.
            return _stage_lighting.__wrapped__(
                state, gb_c, shadow_maps, config.pcf_bitmask,
                config.pcf_f16, config.pcf_q8,
                config.shadowless_strength_eps, ss_c,
                pcf_window2d=config.pcf_window2d,
            )

        def chunk_sun_pcf(gb_c):
            # share_sun_pcf IN-CHUNK (both fused-chunks variants — with and
            # without records — reach here with sun_shadow=None): evaluate
            # the one sun PCF both the lighting body and the camera pass
            # need from THIS chunk's G-buffer — a chunk-local value, not
            # a hoisted (H, W) buffer that would serialize the passes.
            # Bitwise: both consumers
            # evaluate the identical sample_shadow_map(compute_shadow_frame)
            # chain (tests/test_lighting.py::test_share_sun_pcf_bitwise).
            if not (config.share_sun_pcf and lit is None):
                return None
            return _sun_pcf(state, gb_c, shadow_maps, config)

        def gb_of(sl):
            # resolve_in_sky_chunks: resolve THIS chunk's G-buffer from
            # the sliced visibility buffer + the per-triangle records
            # (purely per-pixel; see resolve_gbuffer_from_records).
            from syzygy_tpu.kernels.resolve import (
                resolve_gbuffer_from_records,
            )

            return resolve_gbuffer_from_records(
                jax.tree.map(sl, vis_full), records, geometry
            )

        def camera_pass(lit_c, depth_c, gb_c, origin_c, sun_shadow_c):
            return sky_camera_pass(
                lit_c,
                depth_c,
                gb_c,
                state.camera,
                state.atmosphere,
                t_lut_px,
                sky_lut,
                sun,
                shadow_maps[0],
                draw_extent=(config.render_width, config.render_height),
                row_origin=origin_c,
                metallic_reflection=config.metallic_reflection,
                fast=config.fast_sky,
                fast_reflection=config.fast_sky_reflection,
                aerial=aerial,
                aerial_t_max=t_max_mm,
                tseg_rows=tseg_packed,
                pcf_bitmask=config.pcf_bitmask,
                pcf_f16=config.pcf_f16,
                pcf_q8=config.pcf_q8,
                pcf_window2d=config.pcf_window2d,
                sun_shadow=sun_shadow_c,
            )

        h, w = vis_depth.shape[0], vis_depth.shape[1]
        n_chunks = _sky_chunks(h, config.sky_row_chunks)
        if n_chunks > 1:
            rows = h // n_chunks

            def one(i):
                sl = lambda a: jax.lax.dynamic_slice_in_dim(a, i * rows, rows, 0)
                gb_c = gb_of(sl) if records is not None else jax.tree.map(
                    sl, gbuffer
                )
                ss_c = (
                    chunk_sun_pcf(gb_c) if sun_shadow is None
                    else sl(sun_shadow)
                )
                lit_c = lit_of(gb_c, ss_c) if lit is None else sl(lit)
                return camera_pass(
                    lit_c, sl(vis_depth), gb_c,
                    row0 + i * rows,
                    ss_c,
                )

            color = jax.lax.map(one, jnp.arange(n_chunks)).reshape(h, w, 3)
        else:
            gb_full = (
                gb_of(lambda a: a) if records is not None else gbuffer
            )
            ss_full = (
                chunk_sun_pcf(gb_full) if sun_shadow is None else sun_shadow
            )
            color = camera_pass(
                lit_of(gb_full, ss_full) if lit is None else lit,
                vis_depth, gb_full, row0, ss_full,
            )
        color = jnp.clip(color, 0.0, 1.0)
    else:
        color = lit
    if config.debug_lines:
        from syzygy_tpu.kernels.debuglines import draw_lines

        proj_view = state.camera.projection @ state.camera.view
        color = draw_lines(
            color,
            vis_depth,
            state.debug_segments,
            state.debug_valid,
            proj_view,
            (config.width, config.height),
        )
    if config.supersample > 1:
        ss = config.supersample
        h = (color.shape[0] // ss) * ss
        w = (config.render_width // ss) * ss
        color = color[:h, :w].reshape(
            h // ss, ss, w // ss, ss, 3
        ).mean(axis=(1, 3))
    if config.oetf == "srgb":
        return oetf_srgb(color)
    return oetf_pure_gamma(color)


@functools.partial(jax.jit, static_argnames=("config", "row0"))
def _stage_lighting_sky(
    state: FrameState,
    vis_depth,
    gbuffer,
    shadow_maps,
    config,
    row0: int = 0,
    vis_full=None,
    records=None,
    geometry=None,
):
    """Lighting + sky fused into one device program (RenderConfig.
    fuse_lighting_sky): same math, one fewer dispatch per frame."""
    if records is not None:
        # resolve_in_sky_chunks: no full-frame G-buffer exists — resolve,
        # lighting and sky all run per row chunk (lit=None, gbuffer=None)
        return _stage_sky.__wrapped__(
            state, None, vis_depth, None, shadow_maps, config, row0, None,
            vis_full, records, geometry,
        )
    if config.fuse_lighting_sky_chunks and config.render_atmosphere:
        # lighting runs per row chunk inside the sky map (lit=None);
        # sun_shadow=None so share_sun_pcf (if on) takes the chunk-local
        # in-chunk form there — never a hoisted (H, W) buffer.
        return _stage_sky.__wrapped__(
            state, None, vis_depth, gbuffer, shadow_maps, config, row0,
            None,
        )
    sun_shadow = None
    if config.share_sun_pcf and config.render_atmosphere:
        sun_shadow = _sun_pcf(state, gbuffer, shadow_maps, config)
    lit = _stage_lighting.__wrapped__(
        state, gbuffer, shadow_maps, config.pcf_bitmask, config.pcf_f16,
        config.pcf_q8, config.shadowless_strength_eps, sun_shadow,
        pcf_window2d=config.pcf_window2d,
    )
    return _stage_sky.__wrapped__(
        state, lit, vis_depth, gbuffer, shadow_maps, config, row0, sun_shadow
    )


def _finish_frame(state, vis, gbuffer, shadow_maps, config, geometry=None):
    """``gbuffer`` holds the pre-joined records instead of a G-buffer when
    the geometry stage deferred the resolve (resolve_in_sky_chunks)."""
    if geometry is not None and _defers_resolve(config, geometry):
        return _stage_lighting_sky(
            state, vis.depth, None, shadow_maps, config, 0,
            vis, gbuffer, geometry,
        )
    if config.fuse_lighting_sky or (
        config.fuse_lighting_sky_chunks and config.render_atmosphere
    ):
        return _stage_lighting_sky(
            state, vis.depth, gbuffer, shadow_maps, config
        )
    sun_shadow = None
    if config.share_sun_pcf and config.render_atmosphere:
        sun_shadow = _stage_sun_pcf(
            state, gbuffer, shadow_maps, config.pcf_bitmask, config.pcf_f16,
            config.pcf_q8, pcf_window2d=config.pcf_window2d,
        )
    lit = _stage_lighting(
        state, gbuffer, shadow_maps, config.pcf_bitmask, config.pcf_f16,
        config.pcf_q8, config.shadowless_strength_eps, sun_shadow,
        pcf_window2d=config.pcf_window2d,
    )
    return _stage_sky(
        state, lit, vis.depth, gbuffer, shadow_maps, config, 0, sun_shadow
    )


def render_frame(
    geometry: GeometryStatic, params: FrameParams, config: RenderConfig
) -> jnp.ndarray:
    """Scene state -> (height, width, 3) nonlinear-encoded image in [0, 1].

    Two chained device programs by default (three with
    ``fuse_lighting_sky=False``); the
    host enqueues them all without syncing (one logical queue submission,
    like editor.cpp:396-401).
    """
    state, vis, gbuffer, shadow_maps = _stage_geometry(geometry, params, config)
    encoded = _finish_frame(state, vis, gbuffer, shadow_maps, config, geometry)
    return encoded[: config.height, : config.width]


@functools.partial(
    jax.jit, static_argnames=("spec", "config", "row0", "local_rows")
)
def _stage_geometry_packed(
    geometry, buffer, spec, config, row0: int = 0, local_rows: int | None = None
):
    params = unflatten_frame_params(spec, buffer)
    return _stage_geometry.__wrapped__(geometry, params, config, row0, local_rows)


def render_frame_packed(
    geometry: GeometryStatic, buffer, spec, config: RenderConfig
) -> jnp.ndarray:
    """Like :func:`render_frame` but takes a flattened FrameParams buffer
    (ONE host->device upload per frame; see
    ``scene.pack.flatten_frame_params``)."""
    state, vis, gbuffer, shadow_maps = _stage_geometry_packed(
        geometry, buffer, spec, config
    )
    encoded = _finish_frame(state, vis, gbuffer, shadow_maps, config, geometry)
    return encoded[: config.height, : config.width]


# ---------------------------------------------------------------------------
# whole-pipeline pure function (multi-chip row blocks; also CPU tests)
# ---------------------------------------------------------------------------


def render_frame_rows(
    geometry: GeometryStatic,
    params: FrameParams,
    config: RenderConfig,
    row0,
    local_rows: int,
    shadow_shard_axis: str | None = None,
) -> jnp.ndarray:
    """Render rows [row0, row0 + local_rows) of the padded frame.

    ``row0`` may be traced (each device renders its row block under
    shard_map; shadow maps and LUTs are recomputed per device — small next to
    the per-pixel work). ``local_rows`` must be a tile multiple.

    Runs the SAME frame formulation as the single-device path:
    :func:`_geometry_body` (deferring the resolve into
    records when ``resolve_in_sky_chunks``) then
    :func:`_stage_lighting_sky`'s dispatch, which honors
    ``fuse_lighting_sky_chunks`` / ``resolve_in_sky_chunks`` — all of
    resolve + lighting + sky run inside the row-chunk ``lax.map`` exactly as
    they do on one chip. The only difference from single-chip is program
    partitioning: under ``shard_map`` the whole frame is necessarily one
    program (the 2/3-program chaining is a host-dispatch concern).
    """
    state, vis, gbuffer, shadow_maps = _geometry_body(
        geometry, params, config, row0, local_rows, shadow_shard_axis
    )
    if _defers_resolve(config, geometry):
        # gbuffer holds the pre-joined records; resolve + lighting + sky
        # all run per row chunk (the fused-chunks production formulation)
        return _stage_lighting_sky.__wrapped__(
            state, vis.depth, None, shadow_maps, config, row0,
            vis, gbuffer, geometry,
        )
    return _stage_lighting_sky.__wrapped__(
        state, vis.depth, gbuffer, shadow_maps, config, row0
    )

"""Sky/ground/aerial-perspective camera pass (port of ``camera.comp``).

Consumes the lit scene color, depth, G-buffer, sun shadow map and the two
atmosphere LUTs; produces the final pre-OETF color including the reference's
ad-hoc ``pow(10 * luminance * sunIntensity + surfaceLuminance, 1.2)`` tonemap
(``camera.comp:389-393``). All branches are computed as masked lanes.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from syzygy_tpu.kernels.atmosphere import (
    METERS_PER_MM,
    PI,
    luminance_scattering_integral,
    luminance_scattering_integral_fast,
    ray_sphere_intersect,
    safe_sqrt,
    sample_lut_bilinear,
    sample_transmittance_ray,
    sample_transmittance_segment,
)
from syzygy_tpu.kernels.lighting import (
    PBRTexel,
    compute_fresnel,
    compute_shadow_frame,
    convert_pbr,
    diffuse_brdf,
    sample_shadow_map,
    specular_brdf,
    _dot1,
    _normalize,
)
from syzygy_tpu.kernels.resolve import GBuffer
from syzygy_tpu.scene.atmosphere import AtmospherePacked
from syzygy_tpu.scene.camera import CameraPacked
from syzygy_tpu.scene.lights import DirectionalLight


def _skyview_uv(atmo: AtmospherePacked, position, direction):
    """Direction -> skyview LUT (u, v), ``sampleMap_Direction``
    (``camera.comp:70-121``)."""
    normalized = direction / _norm3(direction)
    sin_horizon = atmo.planet_radius_mm / _norm3(position)[..., 0]
    horizon_zenith = PI - jnp.arcsin(jnp.clip(sin_horizon, -1.0, 1.0))
    cos_view_zenith = normalized[..., 1]
    cos_horizon_zenith = -safe_sqrt(1.0 - sin_horizon * sin_horizon)
    view_zenith = jnp.arccos(jnp.clip(normalized[..., 1], -1.0, 1.0))

    above = cos_view_zenith > cos_horizon_zenith
    frac_above = view_zenith / jnp.maximum(horizon_zenith, 1e-12)
    v_above = (1.0 - safe_sqrt(1.0 - frac_above)) * 0.5
    frac_below = (view_zenith - horizon_zenith) / jnp.maximum(
        PI - horizon_zenith, 1e-12
    )
    v_below = safe_sqrt(frac_below) * 0.5 + 0.5
    v = jnp.where(above, v_above, v_below)

    light_proj = -jnp.stack(
        [atmo.incident_direction_sun[0], atmo.incident_direction_sun[2]]
    )
    light_proj = light_proj / jnp.maximum(jnp.linalg.norm(light_proj), 1e-12)
    view_proj = jnp.stack([direction[..., 0], direction[..., 2]], axis=-1)
    view_proj = view_proj / jnp.maximum(
        jnp.linalg.norm(view_proj, axis=-1, keepdims=True), 1e-12
    )
    u = (
        jnp.clip(
            light_proj[0] * view_proj[..., 0] + light_proj[1] * view_proj[..., 1],
            -1.0,
            1.0,
        )
        * 0.5
        + 0.5
    )
    return u, v


def sample_skyview(atmo: AtmospherePacked, skyview_lut, position, direction):
    """``sampleMap_Direction`` (``camera.comp:70-121``)."""
    u, v = _skyview_uv(atmo, position, direction)
    return sample_lut_bilinear(skyview_lut, u, v)


def sample_skyview_ground(
    atmo: AtmospherePacked, skyview_lut, position, direction
):
    """Skyview sample for a PLANET-HITTING ray, used when the LUT stands in
    for the per-pixel aerial integral (aerial_lut mode). Clamps v so both
    bilinear rows lie in the below-horizon half: interpolating across the
    v=0.5 horizon row mixes bright sky-escape in-scatter into ground rays
    (measured up to ~0.47 at 1080p near the horizon line)."""
    if hasattr(skyview_lut, "h"):
        h = skyview_lut.h
    else:
        h = skyview_lut.shape[0]
    u, v = _skyview_uv(atmo, position, direction)
    return sample_lut_bilinear(
        skyview_lut, u, jnp.maximum(v, 0.5 + 0.5 / h)
    )


def _norm3(v):
    return jnp.sqrt(jnp.maximum(jnp.sum(v * v, axis=-1, keepdims=True), 1e-20))


def sample_sun_disk(atmo, transmittance_lut, position, direction):
    """``sampleSunDisk`` (``camera.comp:123-140``)."""
    to_sun = -atmo.incident_direction_sun
    cos_dir_sun = jnp.sum(direction * to_sun, axis=-1) / (
        _norm3(direction)[..., 0] * jnp.linalg.norm(to_sun)
    )
    sin_sun_radius = atmo.sun_angular_radius
    sin_dir_sun = safe_sqrt(1.0 - cos_dir_sun * cos_dir_sun)
    transmittance = sample_transmittance_ray(
        transmittance_lut, atmo, position, direction
    )
    edge0 = 0.2 * sin_sun_radius
    edge1 = sin_sun_radius
    t = jnp.clip((sin_dir_sun - edge0) / jnp.maximum(edge1 - edge0, 1e-12), 0.0, 1.0)
    smooth = t * t * (3.0 - 2.0 * t)
    disk = transmittance * (1.0 - smooth)[..., None]
    return jnp.where((cos_dir_sun < 0.0)[..., None], 0.0, disk)


def fraction_of_sun_visible(atmo, radius):
    """``computeFractionOfSunVisible`` (``camera.comp:142-147``) — the
    reference early-returns sinHorizonZenith; reproduced."""
    return atmo.planet_radius_mm / radius


def _hit_planet(atmo, origin, direction):
    hit, t0, _ = ray_sphere_intersect(origin, direction, atmo.planet_radius_mm)
    return hit & (t0 > 0.0), t0


def sample_ground(
    atmo, transmittance_lut, origin, direction, dist, aerial=None,
    fast=False,
):
    """``sampleGround`` (``camera.comp:203-235``).

    ``aerial`` optionally injects a precomputed in-scattering integral for
    the same (origin, direction, dist) — the caller may share ONE integral
    across mutually-exclusive branches (see :func:`sky_camera_pass`)."""
    surface = origin + dist[..., None] * direction
    surface_normal = surface / _norm3(surface)
    light_dir = -atmo.incident_direction_sun
    view_dir = -direction
    halfway = _normalize(light_dir + view_dir)
    spec_power = 160.0
    microfacet = jnp.power(
        jnp.clip(_dot1(halfway, surface_normal), 0.0, 1.0), spec_power
    )
    specular = (spec_power + 2.0) / 8.0 * microfacet
    diffuse = 0.4 / PI
    fresnel = 0.04 + (1.0 - 0.04) * jnp.power(
        1.0 - jnp.clip(_dot1(halfway, light_dir), 0.0, 1.0), 5.0
    )
    albedo = diffuse * (1.0 - fresnel) + specular * fresnel
    t_sun = sample_transmittance_ray(
        transmittance_lut, atmo, surface, jnp.broadcast_to(light_dir, surface.shape)
    )
    nl = jnp.clip(
        jnp.sum(surface_normal * light_dir, axis=-1, keepdims=True), 0.0, 1.0
    )
    surface_lum = t_sun * albedo * nl
    t_surface = sample_transmittance_segment(transmittance_lut, atmo, origin, surface)
    if aerial is None:
        integral = (
            luminance_scattering_integral_fast
            if fast
            else luminance_scattering_integral
        )
        aerial = integral(atmo, transmittance_lut, origin, direction, dist)
    return surface_lum * t_surface + aerial


def sample_environment(
    atmo, transmittance_lut, skyview_lut, position, direction,
    hit_dist=None, aerial=None, fast=False,
):
    """``sampleEnvironmentLuminanceTransfer`` (``camera.comp:286-301``)
    (the sunShadowFactor multiplies only the sun disk at the call sites)."""
    if hit_dist is None:
        hit, dist = _hit_planet(atmo, position, direction)
    else:
        hit, dist = hit_dist
    ground = sample_ground(
        atmo, transmittance_lut, position, direction, dist, aerial=aerial,
        fast=fast,
    )
    sky = sample_skyview(atmo, skyview_lut, position, direction)
    disk = sample_sun_disk(atmo, transmittance_lut, position, direction)
    return jnp.where(hit[..., None], ground, sky), jnp.where(
        hit[..., None], 0.0, disk
    )


def compute_skyview_tseg(atmo, transmittance_lut, position, height: int):
    """Per-ROW camera->planet-surface segment transmittance for the skyview
    LUT's elevation parameterization, (height, 3) f32.

    ``sampleTransmittanceLUT_Segment`` (``common.glinl:114-136``) along a
    ground-hitting camera ray depends only on the ray's elevation (the
    atmosphere is spherically symmetric and the camera radius is fixed per
    frame) — exactly the skyview LUT's v axis, whose horizon-centered sqrt
    warp (``skyview_LUT.comp:51-89``) concentrates rows where t_seg varies
    fastest. Packed via :func:`pack_tseg_rows` into a tiny (h, 6) table,
    one small-table gather replaces the env branch's two per-pixel
    transmittance-segment gathers (RenderConfig.skyview_tseg; the exact
    per-pixel path remains the skyview_tseg=False mode). Rows above the
    horizon (no planet hit) hold 1.0 and are never selected."""
    r = jnp.sqrt(jnp.maximum(jnp.sum(position * position), 1e-20))
    sin_horizon = jnp.clip(atmo.planet_radius_mm / r, -1.0, 1.0)
    horizon_zenith = PI - jnp.arcsin(sin_horizon)
    v = (jnp.arange(height, dtype=jnp.float32) + 0.5) / height
    # invert the v parameterization (_skyview_uv): below-horizon half
    frac_below = jnp.square((v - 0.5) * 2.0)
    vz_below = horizon_zenith + frac_below * (PI - horizon_zenith)
    frac_above = 1.0 - jnp.square(1.0 - 2.0 * v)
    vz_above = frac_above * horizon_zenith
    view_zenith = jnp.where(v >= 0.5, vz_below, vz_above)
    direction = jnp.stack(
        [jnp.sin(view_zenith), jnp.cos(view_zenith), jnp.zeros_like(v)],
        axis=-1,
    )  # (height, 3); on-axis origin — t_seg is rotation-invariant
    pos_axis = jnp.broadcast_to(
        jnp.stack([jnp.zeros_like(r), r, jnp.zeros_like(r)]), direction.shape
    )
    hit, dist = _hit_planet(atmo, pos_axis, direction)
    surface = pos_axis + dist[..., None] * direction
    t_seg = sample_transmittance_segment(
        transmittance_lut, atmo, pos_axis, surface
    )
    return jnp.where(hit[..., None], t_seg, 1.0)


def pack_tseg_rows(rows: jnp.ndarray) -> jnp.ndarray:
    """(h, 3) :func:`compute_skyview_tseg` rows -> (h, 6) packed pairs
    ``[t(y), t(y+1)]`` (edge-clamped), so a v-interpolated sample is ONE
    gather from a table of a few KB (it replaces two transmittance-LUT
    gathers)."""
    h = rows.shape[0]
    yd = jnp.minimum(jnp.arange(h) + 1, h - 1)
    return jnp.concatenate([rows, rows[yd]], axis=-1)


def _sample_tseg_rows(packed: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """v-only linear sample of a :func:`pack_tseg_rows` table, using the
    SAME v->row mapping as :func:`..atmosphere.sample_lut_bilinear` (so the
    result equals bilinear-sampling the rows broadcast across columns)."""
    h = packed.shape[0]
    y = jnp.clip(v * h - 0.5, 0.0, h - 1.0)
    y0 = jnp.floor(y).astype(jnp.int32)
    fy = (y - y0)[..., None]
    q = packed[y0]  # (..., 6): one gather
    return q[..., 0:3] * (1 - fy) + q[..., 3:6] * fy


def sample_environment_shared(
    atmo, transmittance_lut, skyview_lut, position, direction, tseg_rows=None
):
    """``sampleEnvironmentLuminanceTransfer`` (``camera.comp:286-301``) with
    branch-shared gathers, for the aerial-LUT path.

    The ground branch (planet hit) and the sky branch (miss) are mutually
    exclusive per pixel, so their LUT lookups collapse by selecting INPUT
    coordinates per branch before ONE gather each: the skyview sample (sky
    luminance on miss / the ground ray's aerial+transfer stand-in on hit,
    i.e. :func:`sample_skyview_ground`'s clamped v) and the transmittance
    sample (surface->sun on hit / along-ray for the sun disk on miss).
    Per-lane bitwise identical to
    ``sample_environment(..., aerial=sample_skyview_ground(...))``;
    equality pinned by tests/test_sky.py. 4 gathers total instead of 6.

    ``tseg_rows`` (a :func:`pack_tseg_rows` table over the skyview v axis)
    replaces the ground branch's 2-gather per-pixel transmittance segment
    sample with ONE tiny-table gather — 3 gathers total. Closeness-bounded,
    not bitwise (tests/test_sky.py::test_skyview_tseg_frame_close). A
    separate table keeps the 100 MB skyview quad at 12 channels instead of
    widening every one of its rows."""
    hit, dist = _hit_planet(atmo, position, direction)
    surface = position + dist[..., None] * direction

    # shared skyview gather (miss: v; hit: below-horizon clamped v)
    h = skyview_lut.h if hasattr(skyview_lut, "h") else skyview_lut.shape[0]
    u, v = _skyview_uv(atmo, position, direction)
    v_sel = jnp.where(hit, jnp.maximum(v, 0.5 + 0.5 / h), v)
    sky = sample_lut_bilinear(skyview_lut, u, v_sel)
    if tseg_rows is not None:
        t_seg_lut = _sample_tseg_rows(tseg_rows, v_sel)

    # shared transmittance gather (hit: surface->sun; miss: ray for disk)
    light_dir = -atmo.incident_direction_sun
    ld_b = jnp.broadcast_to(light_dir, surface.shape)
    r_srf = _norm3(surface)[..., 0]
    mu_srf = jnp.sum(surface * ld_b, axis=-1) / (
        r_srf * _norm3(ld_b)[..., 0]
    )
    r_ray = _norm3(position)[..., 0]
    mu_ray = jnp.sum(position * direction, axis=-1) / (
        r_ray * _norm3(direction)[..., 0]
    )
    from syzygy_tpu.kernels.atmosphere import sample_transmittance_rmu

    t_shared = sample_transmittance_rmu(
        transmittance_lut,
        atmo,
        jnp.where(hit, r_srf, r_ray),
        jnp.where(hit, mu_srf, mu_ray),
    )

    # ground shading (sampleGround, camera.comp:203-235; t_sun = t_shared)
    surface_normal = surface / _norm3(surface)
    view_dir = -direction
    halfway = _normalize(light_dir + view_dir)
    spec_power = 160.0
    microfacet = jnp.power(
        jnp.clip(_dot1(halfway, surface_normal), 0.0, 1.0), spec_power
    )
    specular = (spec_power + 2.0) / 8.0 * microfacet
    diffuse = 0.4 / PI
    fresnel = 0.04 + (1.0 - 0.04) * jnp.power(
        1.0 - jnp.clip(_dot1(halfway, light_dir), 0.0, 1.0), 5.0
    )
    albedo = diffuse * (1.0 - fresnel) + specular * fresnel
    nl = jnp.clip(
        jnp.sum(surface_normal * light_dir, axis=-1, keepdims=True), 0.0, 1.0
    )
    surface_lum = t_shared * albedo * nl
    if tseg_rows is not None:
        t_surface = t_seg_lut
    else:
        t_surface = sample_transmittance_segment(
            transmittance_lut, atmo, position, surface
        )
    ground = surface_lum * t_surface + sky

    # sun disk (sampleSunDisk, camera.comp:123-140; transmittance = t_shared)
    to_sun = -atmo.incident_direction_sun
    cos_dir_sun = jnp.sum(direction * to_sun, axis=-1) / (
        _norm3(direction)[..., 0] * jnp.linalg.norm(to_sun)
    )
    sin_sun_radius = atmo.sun_angular_radius
    sin_dir_sun = safe_sqrt(1.0 - cos_dir_sun * cos_dir_sun)
    edge0 = 0.2 * sin_sun_radius
    edge1 = sin_sun_radius
    t = jnp.clip(
        (sin_dir_sun - edge0) / jnp.maximum(edge1 - edge0, 1e-12), 0.0, 1.0
    )
    smooth = t * t * (3.0 - 2.0 * t)
    disk = t_shared * (1.0 - smooth)[..., None]
    disk = jnp.where((cos_dir_sun < 0.0)[..., None], 0.0, disk)

    return jnp.where(hit[..., None], ground, sky), jnp.where(
        hit[..., None], 0.0, disk
    )


def geometry_luminance_transfer(
    atmo, transmittance_lut, origin, direction, material_pos, material: PBRTexel,
    shadow_factor, aerial=None, t_surface=None, t_sun=None,
):
    """``computeGeometryLuminanceTransfer`` (``camera.comp:237-278``).

    ``t_surface``/``t_sun`` optionally inject precomputed camera->surface
    path transmittance and surface->sun transmittance (the aerial froxel
    volume stores both)."""
    surface = material_pos
    if t_surface is None:
        t_surface = sample_transmittance_segment(
            transmittance_lut, atmo, origin, surface
        )
    light_dir = _normalize(-atmo.incident_direction_sun)[None, None, :]
    view_dir = -direction / _norm3(direction)
    shadowed_by_planet, _ = _hit_planet(
        atmo, surface, jnp.broadcast_to(light_dir, surface.shape)
    )
    diffuse = diffuse_brdf(material)
    specular = specular_brdf(material, light_dir, view_dir)
    fresnel = compute_fresnel(material, light_dir, view_dir)
    if t_sun is None:
        t_sun = sample_transmittance_ray(
            transmittance_lut, atmo, surface,
            jnp.broadcast_to(light_dir, surface.shape),
        )
    frac_visible = fraction_of_sun_visible(atmo, _norm3(material_pos)[..., 0])
    nl = jnp.clip(_dot1(material.normal, light_dir), 0.0, 1.0)
    surface_transfer = (
        shadow_factor[..., None]
        * frac_visible[..., None]
        * (~shadowed_by_planet)[..., None].astype(jnp.float32)
        * t_sun
        * t_surface
        * material.occlusion
        * (diffuse * (1.0 - fresnel) + specular * fresnel)
        * nl
    )
    if aerial is None:
        dist = jnp.linalg.norm(surface - origin, axis=-1)
        aerial = luminance_scattering_integral(
            atmo, transmittance_lut, origin, direction, dist
        )
    return surface_transfer + aerial


def reflect_direction(normal, outgoing):
    """``reflectDirection`` (``camera.comp:280-284``)."""
    parallel = _dot1(normal, outgoing) * normal
    return 2.0 * parallel - outgoing


# ---------------------------------------------------------------------------
# Aerial-perspective froxel LUT (production Hillaire; RenderConfig.aerial_lut)
# ---------------------------------------------------------------------------


def build_aerial_lut(
    atmo: AtmospherePacked,
    transmittance_lut,
    camera: CameraPacked,
    origin_mm: jnp.ndarray,  # (3,) camera position in sky space (+y up, Mm)
    t_max_mm: float,
    n_x: int = 32,
    n_y: int = 32,
    n_slices: int = 16,
) -> jnp.ndarray:
    """Camera-frustum aerial-perspective LUT (Hillaire's production froxel
    volume): ``lut[y, x, j]`` = the EXACT reference in-scattering integral
    (``computeLuminanceScatteringIntegral``) along the camera ray through
    screen point ((x+.5)/n_x, (y+.5)/n_y), marched to distance
    ``(j+1)/n_slices)^2 * t_max_mm`` (square slice spacing: resolution
    where aerial perspective changes fastest). Geometry pixels then
    interpolate this 32x32x16 volume instead of each running their own
    32-step march — the integrand is smooth in (direction, distance), so
    trilinear error is far below the parity budget (measured in
    tests/test_sky.py::test_aerial_lut_mode_close)."""
    xs = ((jnp.arange(n_x, dtype=jnp.float32) + 0.5) / n_x - 0.5) * 2.0
    ys = ((jnp.arange(n_y, dtype=jnp.float32) + 0.5) / n_y - 0.5) * 2.0
    clip_uv = jnp.stack(
        [
            jnp.broadcast_to(xs[None, :], (n_y, n_x)),
            jnp.broadcast_to(ys[:, None], (n_y, n_x)),
        ],
        axis=-1,
    )
    ones = jnp.ones((n_y, n_x, 1), jnp.float32)
    view_h = jnp.concatenate([clip_uv, ones, ones], axis=-1) @ (
        camera.inverse_projection.T
    )
    direction = (view_h @ camera.rotation.T)[..., :3]
    direction = direction / _norm3(direction)
    direction = direction * jnp.array([1.0, -1.0, 1.0], jnp.float32)

    origin = jnp.broadcast_to(origin_mm, direction.shape)
    fracs = ((jnp.arange(n_slices, dtype=jnp.float32) + 1.0) / n_slices) ** 2
    light_dir = _normalize(-atmo.incident_direction_sun)

    def one_slice(frac):
        dist = jnp.full((n_y, n_x), frac * t_max_mm, jnp.float32)
        lum = luminance_scattering_integral(
            atmo, transmittance_lut, origin, direction, dist
        )
        slice_pos = origin + dist[..., None] * direction
        # path transmittance camera -> slice, the same LUT-segment form the
        # per-pixel pass uses (camera.comp:303-...; sampled per froxel here)
        t_seg = sample_transmittance_segment(
            transmittance_lut, atmo, origin, slice_pos
        )
        # sun transmittance AT the slice point (geometry pixels otherwise
        # each pay a per-pixel LUT gather for it, camera.comp:237-278)
        t_sun = sample_transmittance_ray(
            transmittance_lut,
            atmo,
            slice_pos,
            jnp.broadcast_to(light_dir, slice_pos.shape),
        )
        return jnp.concatenate([lum, t_seg, t_sun], axis=-1)  # (n_y, n_x, 9)

    sliced = jax.lax.map(one_slice, fracs)  # (n_slices, n_y, n_x, 9)
    aerial = jnp.moveaxis(sliced, 0, 2)  # (n_y, n_x, n_slices, 9)
    t_sun0 = sample_transmittance_ray(
        transmittance_lut, atmo, origin_mm, light_dir
    )  # (3,): the implicit distance-0 slice's sun transmittance

    # Quad-pack the trilinear footprint: entry (y, x, s) holds all 8 corner
    # records (in-scatter rgb + path-T rgb + sun-T rgb = 72 contiguous
    # f32), so a sample is ONE gather (the same trick as
    # atmosphere.PackedLUT; the volume is only ~4.7 MB packed).
    n_y, n_x, n_s = aerial.shape[0], aerial.shape[1], aerial.shape[2]
    xr = jnp.minimum(jnp.arange(n_x) + 1, n_x - 1)
    yd = jnp.minimum(jnp.arange(n_y) + 1, n_y - 1)
    sn = jnp.minimum(jnp.arange(n_s) + 1, n_s - 1)
    a00 = aerial
    a01 = aerial[:, xr]
    a10 = aerial[yd]
    a11 = aerial[yd][:, xr]
    packed = jnp.concatenate(
        [
            a00,
            a01,
            a10,
            a11,
            a00[:, :, sn],
            a01[:, :, sn],
            a10[:, :, sn],
            a11[:, :, sn],
        ],
        axis=-1,
    )  # (n_y, n_x, n_s, 72): [s0: 00,01,10,11 | s1: 00,01,10,11], 9ch each
    return AerialLUT(packed.reshape(n_y * n_x * n_s, 72), t_sun0, n_y, n_x, n_s)


@jax.tree_util.register_pytree_node_class
class AerialLUT:
    """Quad-packed froxel volume from :func:`build_aerial_lut`: per entry
    8 trilinear corner records of (in-scatter rgb, path-transmittance rgb,
    sun-transmittance rgb); ``t_sun0`` = sun transmittance at the camera
    (the implicit distance-0 slice's value)."""

    def __init__(
        self, packed: jnp.ndarray, t_sun0: jnp.ndarray,
        n_y: int, n_x: int, n_s: int,
    ):
        self.packed = packed  # (n_y * n_x * n_s, 72) f32
        self.t_sun0 = t_sun0  # (3,) f32
        self.n_y = n_y
        self.n_x = n_x
        self.n_s = n_s

    def tree_flatten(self):
        return (self.packed, self.t_sun0), (self.n_y, self.n_x, self.n_s)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0], children[1], *aux)


def sample_aerial_lut(aerial: AerialLUT, uv, dist_mm, t_max_mm: float):
    """Trilinear sample of :func:`build_aerial_lut`'s volume at screen uv
    ([0,1]^2) and ray distance (Mm) -> (in-scatter rgb, path-T rgb,
    sun-T rgb). Clamp-to-edge in y/x/far; distances short of the first
    slice lerp toward the implicit distance-0 slice (no in-scatter, path
    T = 1, sun T = t_sun0). One 72-float gather per sample."""
    n_y, n_x, n_s = aerial.n_y, aerial.n_x, aerial.n_s
    x = jnp.clip(uv[..., 0] * n_x - 0.5, 0.0, n_x - 1.0)
    y = jnp.clip(uv[..., 1] * n_y - 0.5, 0.0, n_y - 1.0)
    # slice centers are at distance ((j+1)/n)^2 * t_max -> inverse: sqrt
    s = jnp.clip(
        jnp.sqrt(jnp.maximum(dist_mm, 0.0) / t_max_mm) * n_s - 1.0,
        -1.0,
        n_s - 1.0,
    )
    x0 = jnp.floor(x).astype(jnp.int32)
    y0 = jnp.floor(y).astype(jnp.int32)
    s0f = jnp.floor(s)
    s0 = jnp.maximum(s0f, -1.0).astype(jnp.int32)  # -1 = implicit zero slice
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    fs = (s - s0f)[..., None]

    q = aerial.packed[(y0 * n_x + x0) * n_s + jnp.maximum(s0, 0)]  # (..., 72)
    if q.dtype != jnp.float32:
        q = q.astype(jnp.float32)  # narrow storage, f32 filtering (lut_f16)

    def bilin(block):  # block: (..., 36) corner records 00,01,10,11 (9ch)
        top = block[..., 0:9] * (1 - fx) + block[..., 9:18] * fx
        bot = block[..., 18:27] * (1 - fx) + block[..., 27:36] * fx
        return top * (1 - fy) + bot * fy

    b0 = bilin(q[..., :36])
    b1 = bilin(q[..., 36:])
    # s0 == -1: the fetched entry's "slice 0" corners ARE slice 0; the
    # implicit distance-0 slice has zero in-scatter, unit path
    # transmittance, and the camera point's sun transmittance.
    zero_slice = jnp.concatenate(
        [
            jnp.zeros_like(b0[..., 0:3]),
            jnp.ones_like(b0[..., 3:6]),
            jnp.broadcast_to(aerial.t_sun0, b0[..., 6:9].shape),
        ],
        axis=-1,
    )
    below = (s0 < 0)[..., None]
    out = jnp.where(
        below,
        zero_slice * (1.0 - fs) + b0 * fs,
        b0 * (1.0 - fs) + b1 * fs,
    )
    return out[..., 0:3], out[..., 3:6], out[..., 6:9]


def sky_camera_pass(
    scene_color: jnp.ndarray,  # (H, W, 3) lit geometry (surfaceLuminance src)
    scene_depth: jnp.ndarray,  # (H, W)
    gbuffer: GBuffer,
    camera: CameraPacked,
    atmo: AtmospherePacked,
    transmittance_lut: jnp.ndarray,
    skyview_lut: jnp.ndarray,
    sun_light: DirectionalLight,  # single (row 0 of the stacked lights)
    sun_shadow_map: jnp.ndarray,  # (dim, dim)
    draw_extent: tuple[int, int] | None = None,  # (w, h) viewport for rays
    row_origin=0,  # global row of this block's first row (image sharding)
    metallic_reflection: bool = True,  # camera.comp:379-387 (ad-hoc bounce)
    fast: bool = False,  # fast in-scattering integral (atmosphere.py)
    # fast integral for the metallic-reflection environment only: the
    # aerial-perspective term of a reflected ray is a second-order effect
    # (scaled by metallic * fresnel * segment transmittance), so the
    # exp-step integral's deviation lands far below the 1e-3 parity budget
    # while halving the pass's 32-step integral count.
    fast_reflection: bool = False,
    # aerial-perspective LUT mode (build_aerial_lut): replaces ALL per-pixel
    # 32-step integrals — geometry pixels trilinear-sample the froxel
    # volume, ground-hit environment pixels reuse the skyview LUT (which
    # integrates the identical path: camera -> planet hit), and the
    # metallic bounce's aerial reuses the skyview LUT from the surface
    # (the reference itself samples the camera-built skyview LUT at
    # surface positions, camera.comp:286-301).
    aerial=None,  # (n_y, n_x, n_slices, 3) from build_aerial_lut, or None
    aerial_t_max: float = 0.0,  # Mm; must match build_aerial_lut's t_max
    # (h, 6) pack_tseg_rows table: env ground branch's camera->surface
    # transmittance from ONE tiny-table gather (RenderConfig.skyview_tseg)
    tseg_rows=None,
    pcf_bitmask: bool = False,  # PCF tap extraction variant (lighting.py)
    pcf_f16: bool = False,  # f16 PCF segment storage (lighting.py)
    pcf_q8: bool = False,  # u8 block-scaled PCF segments (lighting.py)
    pcf_window2d: bool = False,  # one-gather 2D windows (lighting.py)
    # (H, W) precomputed sun PCF visibility (RenderConfig.share_sun_pcf):
    # the lighting pass evaluates the IDENTICAL sample_shadow_map(
    # compute_shadow_frame(sun_pv, material.position, material.normal))
    # for directional light 0, so the frame can compute it once and pass
    # it here — the pass's 5-row PCF gathers + select trees drop out
    # (identical math; differences are XLA reassociation
    # noise — see RenderConfig.share_sun_pcf). None = compute locally.
    sun_shadow=None,
) -> jnp.ndarray:
    """``camera.comp`` main (``:303-395``) -> (H, W, 3) tonemapped color."""
    h, w = scene_depth.shape
    draw_w, draw_h = draw_extent if draw_extent is not None else (w, h)

    # Engine (+y down, meters) -> sky space (+y up, Mm) (camera.comp:318-322)
    position = camera.position[:3] / METERS_PER_MM
    position = position * jnp.array([1.0, -1.0, 1.0], jnp.float32)
    position = position + jnp.array([0.0, atmo.planet_radius_mm, 0.0], jnp.float32)

    # Per-pixel view ray (camera.comp:324-328); integer pixel / drawExtent
    xs = (jnp.arange(w, dtype=jnp.float32)[None, :] / draw_w - 0.5) * 2.0
    rows = jnp.arange(h, dtype=jnp.float32) + jnp.asarray(row_origin, jnp.float32)
    ys = (rows[:, None] / draw_h - 0.5) * 2.0
    clip_uv = jnp.stack(
        [jnp.broadcast_to(xs, (h, w)), jnp.broadcast_to(ys, (h, w))], axis=-1
    )
    near_depth = jnp.ones((h, w, 1), jnp.float32)
    ones = jnp.ones((h, w, 1), jnp.float32)
    view_h = jnp.concatenate([clip_uv, near_depth, ones], axis=-1) @ (
        camera.inverse_projection.T
    )
    direction = (view_h @ camera.rotation.T)[..., :3]
    direction = direction / _norm3(direction)
    direction = direction * jnp.array([1.0, -1.0, 1.0], jnp.float32)

    material = convert_pbr(gbuffer)

    # Sky-space material (camera.comp:371-374)
    flip = jnp.array([1.0, -1.0, 1.0], jnp.float32)
    sky_material_pos = (
        material.position * flip / METERS_PER_MM
        + jnp.array([0.0, atmo.planet_radius_mm, 0.0], jnp.float32)
    )
    sky_material = material._replace(
        normal=material.normal * flip, position=sky_material_pos
    )

    pos_grid = jnp.broadcast_to(position, direction.shape)

    # Branches A (environment) and B (geometry) are mutually exclusive per
    # pixel, so their 32-step in-scattering integrals — the pass's dominant
    # cost — collapse into ONE shared integral over a per-pixel distance
    # (identical to computing both and selecting: only the selected branch's
    # value survives the jnp.where below).
    is_env = (scene_depth == 0.0) | (material.position[..., 1] > 0.0)
    dist_surface = jnp.linalg.norm(sky_material.position - pos_grid, axis=-1)

    # Sun shadow (branch B input; computed first so the merged environment
    # sampling below can weight the reflected sun disk). When the caller
    # already evaluated the identical PCF in the lighting pass
    # (share_sun_pcf), reuse it instead of re-gathering.
    if sun_shadow is None:
        sun_pv = sun_light.projection @ sun_light.view
        coord, dx, dy = compute_shadow_frame(
            sun_pv, material.position, material.normal
        )
        sun_shadow = sample_shadow_map(
            sun_shadow_map, coord, dx, dy,
            bitmask=pcf_bitmask, f16=pcf_f16, q8=pcf_q8,
            window2d=pcf_window2d,
        )

    if aerial is not None:
        # geometry rays: froxel volume; environment ground rays: the skyview
        # LUT already stores the identical camera->planet-hit integral
        uv = jnp.stack(
            [
                jnp.broadcast_to(xs * 0.5 + 0.5, (h, w)),
                jnp.broadcast_to(ys * 0.5 + 0.5, (h, w)),
            ],
            axis=-1,
        )
        geom_aerial, geom_t_surface, geom_t_sun = sample_aerial_lut(
            aerial, uv, dist_surface, aerial_t_max
        )
        # Branch-shared environment sampling: branch A samples the
        # environment along the camera ray; branch B's metallic bounce
        # (camera.comp:379-387) samples it along the reflected ray from the
        # surface. The branches are mutually exclusive per pixel, so select
        # the INPUT coordinates per branch and run ONE sample_environment —
        # per-lane identical to the two-call form (elementwise math on
        # selected inputs) while halving the pass's env gathers + BRDF work.
        if metallic_reflection:
            refl_dir = reflect_direction(sky_material.normal, -direction)
            env_mask = is_env[..., None]
            es_pos = jnp.where(env_mask, pos_grid, sky_material.position)
            es_dir = jnp.where(env_mask, direction, refl_dir)
        else:
            es_pos, es_dir = pos_grid, direction
        env, disk = sample_environment_shared(
            atmo, transmittance_lut, skyview_lut, es_pos, es_dir,
            tseg_rows=tseg_rows,
        )
        # Branch A: background / underground (camera.comp:354-361);
        # shadowFactor = 1 on this branch
        env_transfer = env + disk

        # Branch B: geometry (camera.comp:362-387)
        geo_transfer = geometry_luminance_transfer(
            atmo,
            transmittance_lut,
            pos_grid,
            direction,
            sky_material.position,
            sky_material,
            sun_shadow,
            aerial=geom_aerial,
            t_surface=geom_t_surface,
            t_sun=geom_t_sun,
        )
        if metallic_reflection:
            refl = env + disk * sun_shadow[..., None]
            geo_transfer = geo_transfer + (
                geom_t_surface
                * sky_material.metallic
                * compute_fresnel(sky_material, -direction, refl_dir)
                * refl
            )
    else:
        # Quirk-exact path: per-pixel 32-step integrals, unshared env calls.
        hit, dist_planet = _hit_planet(atmo, pos_grid, direction)
        shared_dist = jnp.where(is_env, dist_planet, dist_surface)
        integral = (
            luminance_scattering_integral_fast
            if fast
            else luminance_scattering_integral
        )
        shared_aerial = integral(
            atmo, transmittance_lut, pos_grid, direction, shared_dist
        )

        # Branch A: background / underground (camera.comp:354-361)
        env, disk = sample_environment(
            atmo, transmittance_lut, skyview_lut, pos_grid, direction,
            hit_dist=(hit, dist_planet), aerial=shared_aerial,
        )
        env_transfer = env + disk  # shadowFactor = 1 on this branch

        # Branch B: geometry (camera.comp:362-387)
        geo_transfer = geometry_luminance_transfer(
            atmo,
            transmittance_lut,
            pos_grid,
            direction,
            sky_material.position,
            sky_material,
            sun_shadow,
            aerial=shared_aerial,
            t_surface=None,
        )
        # ad-hoc single-bounce metallic reflection (camera.comp:379-387)
        if metallic_reflection:
            t_surface = sample_transmittance_segment(
                transmittance_lut, atmo, pos_grid, sky_material.position
            )
            refl_dir = reflect_direction(sky_material.normal, -direction)
            refl_env, refl_disk = sample_environment(
                atmo, transmittance_lut, skyview_lut, sky_material.position,
                refl_dir, fast=fast or fast_reflection,
            )
            refl = refl_env + refl_disk * sun_shadow[..., None]
            geo_transfer = geo_transfer + (
                t_surface
                * sky_material.metallic
                * compute_fresnel(sky_material, -direction, refl_dir)
                * refl
            )

    # Branch select: background or underground -> environment
    # (GBuffer +y down: material.position.y > 0 means below ground)
    transfer = jnp.where(is_env[..., None], env_transfer, geo_transfer)
    surface_luminance = jnp.where(
        is_env[..., None], 0.0, scene_color
    )

    luminance = transfer * atmo.sun_intensity_spectrum
    color = jnp.power(
        jnp.maximum(luminance * 10.0 + surface_luminance, 0.0), 1.2
    )
    return color

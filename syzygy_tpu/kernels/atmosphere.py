"""Hillaire atmospheric scattering: LUT builders + per-pixel sky camera pass.

Port of ``shaders/atmosphere/common.glinl`` (transmittance mapping, extinction,
phase functions, raymarch stepping, the 32-sample single-scattering integral),
``transmittance_LUT.comp`` (512x128, 500 samples), ``skyview_LUT.comp``
(lat-long sky map with horizon-centered parameterization) and ``camera.comp``
(sky/ground/geometry per-pixel pass). All GLSL branches become ``jnp.where``
masks over whole images.

Parity notes (intentionally reproduced reference quirks):
* ``sampleExtinction`` uses ``absorptionRayleighPerMm`` for the Mie absorption
  term (``common.glinl:202``) — with Earth defaults this zeroes Mie absorption.
* ``stepRadiusMu``'s ``mu_sunAndStepDirection`` takes ``safeSqrt`` of a
  difference (``common.glinl:325``), clamping negatives to zero.
* ``computeFractionOfSunVisible`` early-returns ``sinHorizonZenith``
  (``camera.comp:147``), dead-coding the chord computation below it.

Units: megameters, +y up (engine positions are converted with the y flip at
the camera-pass boundary, ``camera.comp:320-328``).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from syzygy_tpu.kernels.common import match_vma

from syzygy_tpu.scene.atmosphere import AtmospherePacked

TRANSMITTANCE_W = 512  # common.glinl:13
TRANSMITTANCE_H = 128
TRANSMITTANCE_SAMPLES = 500  # transmittance_LUT.comp:53
SKYVIEW_W = 2048  # skyview.cpp:175
SKYVIEW_H = 1024
SKYVIEW_SAMPLES = 32  # common.glinl:363
METERS_PER_MM = 1_000_000.0
PI = 3.141592653589793


def safe_sqrt(x):
    return jnp.sqrt(jnp.maximum(x, 0.0))


def _norm(v, axis=-1, keepdims=True):
    return jnp.sqrt(jnp.maximum(jnp.sum(v * v, axis=axis, keepdims=keepdims), 1e-20))


def tex_coord_from_unit_range(value, dim: int):
    """``textureCoordFromUnitRange`` (``common.glinl:29-32``)."""
    return 0.5 / dim + value * (1.0 - 1.0 / dim)


def unit_range_from_tex_coord(coord, dim: int):
    return (coord - 0.5 / dim) / (1.0 - 1.0 / dim)


def transmittance_rmu_to_uv(
    atmo: AtmospherePacked,
    radius,
    mu,
    width: int = TRANSMITTANCE_W,
    height: int = TRANSMITTANCE_H,
):
    """``transmittanceLUT_RMu_to_UV`` (``common.glinl:40-66``).

    ``width``/``height`` are the actual LUT dims (the half-texel insets
    depend on them); default is the reference 512x128."""
    atm_r2 = atmo.atmosphere_radius_mm * atmo.atmosphere_radius_mm
    pl_r2 = atmo.planet_radius_mm * atmo.planet_radius_mm
    h = safe_sqrt(atm_r2 - pl_r2)
    rho = safe_sqrt(radius * radius - pl_r2)
    d = jnp.maximum(
        -radius * mu + safe_sqrt(radius * radius * (mu * mu - 1.0) + atm_r2), 0.0
    )
    d_min = atmo.atmosphere_radius_mm - radius
    d_max = rho + h
    x_mu = (d - d_min) / jnp.maximum(d_max - d_min, 1e-12)
    x_radius = rho / jnp.maximum(h, 1e-12)
    return (
        tex_coord_from_unit_range(x_mu, width),
        tex_coord_from_unit_range(x_radius, height),
    )


def transmittance_uv_to_rmu(
    atmo: AtmospherePacked,
    u,
    v,
    width: int = TRANSMITTANCE_W,
    height: int = TRANSMITTANCE_H,
):
    """``transmittanceLUT_UV_to_RMu`` (``common.glinl:69-102``)."""
    x_mu = unit_range_from_tex_coord(u, width)
    x_radius = unit_range_from_tex_coord(v, height)
    atm_r2 = atmo.atmosphere_radius_mm * atmo.atmosphere_radius_mm
    pl_r2 = atmo.planet_radius_mm * atmo.planet_radius_mm
    h = safe_sqrt(atm_r2 - pl_r2)
    rho = h * x_radius
    radius = jnp.sqrt(rho * rho + pl_r2)
    d_min = atmo.atmosphere_radius_mm - radius
    d_max = rho + h
    d = (d_max - d_min) * x_mu + d_min
    mu = (h * h - rho * rho - d * d) / (2.0 * radius * jnp.maximum(d, 1e-12))
    mu = jnp.clip(mu, -1.0, 1.0)
    return radius, jnp.where(d <= 0.0, 1.0, mu)


@jax.tree_util.register_pytree_node_class
class PackedLUT:
    """Quad-packed LUT: one gather fetches the whole 2x2 bilinear footprint.

    ``quad[y * w + x] = [t(y,x), t(y,x1), t(y1,x), t(y1,x1)]`` (12 channels,
    x1/y1 edge-clamped). A bilinear sample then costs ONE 48-byte contiguous
    gather instead of four texel gathers, with bitwise-identical results.
    ``h``/``w`` ride as pytree aux data so they stay static."""

    def __init__(self, quad: jnp.ndarray, h: int, w: int):
        self.quad = quad  # (h * w, 12) f32
        self.h = h
        self.w = w

    def tree_flatten(self):
        return (self.quad,), (self.h, self.w)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0], aux[0], aux[1])


def pack_lut(lut: jnp.ndarray, dtype=None) -> PackedLUT:
    """(H, W, C) -> :class:`PackedLUT` (done once per frame on device).
    C is 3 for plain LUTs; 6 for the skyview+t_seg extended layout.

    ``dtype`` optionally narrows the stored quad (e.g. ``jnp.float16`` for
    the 100 MB skyview quad: half the bytes per gather). Samples are
    widened back to f32 after the gather, so only storage precision
    changes (~5e-4 relative)."""
    h, w = lut.shape[0], lut.shape[1]
    xr = jnp.minimum(jnp.arange(w) + 1, w - 1)
    yd = jnp.minimum(jnp.arange(h) + 1, h - 1)
    quad = jnp.concatenate(
        [lut, lut[:, xr], lut[yd], lut[yd][:, xr]], axis=-1
    ).reshape(h * w, 4 * lut.shape[-1])
    if dtype is not None:
        quad = quad.astype(dtype)
    return PackedLUT(quad, h, w)


@jax.tree_util.register_pytree_node_class
class PackedLUTQ8:
    """u8 block-scaled quad LUT: 16 bytes/row instead of the f16 quad's 24.

    Each row packs its 2x2 bilinear footprint (12 f32 values for a 3ch
    LUT) as u8 fractions of the ROW'S OWN MAX into 3 uint32 words, plus
    the f32 scale bitcast into a 4th word; a bilinear sample is still ONE
    gather. Decode is shift-by-CONSTANT byte extraction (the catastrophic
    per-lane VARIABLE shifts of the PCF bitmask experiment do not apply).
    Quantization is blockwise-relative: error <= scale/510 where scale is
    the local 2x2 max — tight for smooth fields like the skyview LUT
    (bounded by tests/test_sky.py::test_skyview_q8_frame_close)."""

    def __init__(self, words: jnp.ndarray, h: int, w: int):
        self.words = words  # (h * w, 4) uint32
        self.h = h
        self.w = w

    def tree_flatten(self):
        return (self.words,), (self.h, self.w)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0], aux[0], aux[1])


def pack_lut_q8(lut: jnp.ndarray) -> PackedLUTQ8:
    """(H, W, 3) -> :class:`PackedLUTQ8` (once per frame on device)."""
    assert lut.shape[-1] == 3, lut.shape
    h, w = lut.shape[0], lut.shape[1]
    xr = jnp.minimum(jnp.arange(w) + 1, w - 1)
    yd = jnp.minimum(jnp.arange(h) + 1, h - 1)
    quad = jnp.concatenate(
        [lut, lut[:, xr], lut[yd], lut[yd][:, xr]], axis=-1
    ).reshape(h * w, 12)
    scale = jnp.max(quad, axis=-1, keepdims=True)  # >= 0 (luminance LUTs)
    q = jnp.clip(
        jnp.round(quad / jnp.maximum(scale, 1e-30) * 255.0), 0.0, 255.0
    ).astype(jnp.uint32)
    shifts = jnp.array([0, 8, 16, 24], jnp.uint32)
    packed = jnp.sum(
        q.reshape(h * w, 3, 4) << shifts[None, None, :], axis=-1
    )  # (h*w, 3) uint32
    wscale = jax.lax.bitcast_convert_type(scale[:, 0], jnp.uint32)
    return PackedLUTQ8(
        jnp.concatenate([packed, wscale[:, None]], axis=-1), h, w
    )


def sample_lut_bilinear(lut, u, v) -> jnp.ndarray:
    """Bilinear clamp-to-edge sampling (GLSL texture()) of an (H, W, 3)
    array or a :class:`PackedLUT` / :class:`PackedLUTQ8` (one gather)."""
    if isinstance(lut, (PackedLUT, PackedLUTQ8)):
        h, w = lut.h, lut.w
    else:
        h, w = lut.shape[0], lut.shape[1]
    x = jnp.clip(u * w - 0.5, 0.0, w - 1.0)
    y = jnp.clip(v * h - 0.5, 0.0, h - 1.0)
    x0 = jnp.floor(x).astype(jnp.int32)
    y0 = jnp.floor(y).astype(jnp.int32)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    if isinstance(lut, PackedLUTQ8):
        g = lut.words[y0 * w + x0]  # (..., 4) uint32: the one gather
        scale = jax.lax.bitcast_convert_type(g[..., 3], jnp.float32)
        scale = (scale * (1.0 / 255.0))[..., None]
        vals = [
            ((g[..., j] >> jnp.uint32(8 * b)) & jnp.uint32(255)).astype(
                jnp.float32
            )
            for j in range(3)
            for b in range(4)
        ]
        q = jnp.stack(vals, axis=-1) * scale  # (..., 12) f32
        top = q[..., 0:3] * (1 - fx) + q[..., 3:6] * fx
        bot = q[..., 6:9] * (1 - fx) + q[..., 9:12] * fx
        return top * (1 - fy) + bot * fy
    if isinstance(lut, PackedLUT):
        q = lut.quad[y0 * w + x0]  # (..., 4C): one gather
        if q.dtype != jnp.float32:
            q = q.astype(jnp.float32)  # narrow storage, f32 filtering
        c = q.shape[-1] // 4
        top = q[..., 0 : c] * (1 - fx) + q[..., c : 2 * c] * fx
        bot = q[..., 2 * c : 3 * c] * (1 - fx) + q[..., 3 * c :] * fx
        return top * (1 - fy) + bot * fy
    x1 = jnp.minimum(x0 + 1, w - 1)
    y1 = jnp.minimum(y0 + 1, h - 1)
    top = lut[y0, x0] * (1 - fx) + lut[y0, x1] * fx
    bot = lut[y1, x0] * (1 - fx) + lut[y1, x1] * fx
    return top * (1 - fy) + bot * fy


def sample_transmittance_rmu(lut, atmo, radius, mu):
    if isinstance(lut, PackedLUT):
        w, h = lut.w, lut.h
    else:
        h, w = lut.shape[0], lut.shape[1]
    u, v = transmittance_rmu_to_uv(atmo, radius, mu, w, h)
    return sample_lut_bilinear(lut, u, v)


def sample_transmittance_ray(lut, atmo, position, direction):
    """``sampleTransmittanceLUT_Ray`` (``common.glinl:104-112``)."""
    radius = _norm(position)[..., 0]
    mu = jnp.sum(position * direction, axis=-1) / (
        _norm(position)[..., 0] * _norm(direction)[..., 0]
    )
    return sample_transmittance_rmu(lut, atmo, radius, mu)


def sample_transmittance_segment(lut, atmo, p_from, p_to):
    """``sampleTransmittanceLUT_Segment`` (``common.glinl:114-136``):
    direction-flip trick for precision near the horizon."""
    direction = (p_to - p_from) / _norm(p_to - p_from)
    flip = jnp.sum(p_from * direction, axis=-1, keepdims=True) < 0.0
    a = jnp.where(flip, p_to, p_from)
    b = jnp.where(flip, p_from, p_to)
    d = jnp.where(flip, -direction, direction)
    transmittance = sample_transmittance_ray(lut, atmo, a, d) / jnp.maximum(
        sample_transmittance_ray(lut, atmo, b, d), 1e-20
    )
    return jnp.clip(transmittance, 0.0, 1.0)


def sample_transmittance_sun(lut, atmo, radius, cos_sun_zenith):
    """``sampleTransmittanceLUT_Sun`` (``common.glinl:145-172``)."""
    sin_sun_radius = jnp.sin(atmo.sun_angular_radius)
    cos_sun_radius = jnp.cos(atmo.sun_angular_radius)
    sin_horizon = atmo.planet_radius_mm / radius
    cos_horizon = -safe_sqrt(1.0 - sin_horizon * sin_horizon)
    through = sample_transmittance_rmu(lut, atmo, radius, cos_sun_zenith)
    edge0 = -sin_horizon * sin_sun_radius
    edge1 = sin_horizon * sin_sun_radius
    x = cos_sun_zenith - cos_horizon * cos_sun_radius
    t = jnp.clip((x - edge0) / jnp.maximum(edge1 - edge0, 1e-12), 0.0, 1.0)
    angular = t * t * (3.0 - 2.0 * t)
    return through * angular[..., None]


class ExtinctionSample(NamedTuple):
    scattering_rayleigh: jnp.ndarray
    scattering_mie: jnp.ndarray
    extinction: jnp.ndarray


def sample_extinction(atmo: AtmospherePacked, altitude_mm) -> ExtinctionSample:
    """``sampleExtinction`` (``common.glinl:194-216``) — keeps the reference's
    absorptionRayleigh-for-Mie slip."""
    # Robustness deviation: rays that numerically slip below the surface
    # (altitude resolution at planet radius is ~0.8 m in f32) would blow the
    # exponentials to inf; the reference GLSL has the same hazard but never
    # hits it. Clamp to -1 km.
    alt = jnp.maximum(altitude_mm, -0.001)[..., None]
    density_rayleigh = jnp.exp(-alt / atmo.density_scale_rayleigh_mm)
    scattering_rayleigh = atmo.scattering_rayleigh_per_mm * density_rayleigh
    absorption_rayleigh = atmo.absorption_rayleigh_per_mm * density_rayleigh
    density_mie = jnp.exp(-alt / atmo.density_scale_mie_mm)
    scattering_mie = atmo.scattering_mie_per_mm * density_mie
    absorption_mie = atmo.absorption_rayleigh_per_mm * density_mie  # ref quirk
    altitude_km = altitude_mm * 1000.0
    density_ozone = jnp.maximum(0.0, 1.0 - jnp.abs(altitude_km - 25.0) / 15.0)[
        ..., None
    ]
    scattering_ozone = atmo.scattering_ozone_per_mm * density_ozone
    absorption_ozone = atmo.absorption_ozone_per_mm * density_ozone
    extinction = (
        scattering_rayleigh
        + absorption_rayleigh
        + scattering_mie
        + absorption_mie
        + scattering_ozone
        + absorption_ozone
    )
    return ExtinctionSample(scattering_rayleigh, scattering_mie, extinction)


def ray_sphere_intersect(origin, direction, radius):
    """``raySphereIntersection`` (``common.glinl:220-260``), Haines et al.
    Returns (hit, t0, t1) with t0 <= t1; t unchanged semantics collapsed to
    (0, 0) when missed."""
    f = origin
    d = direction
    b = -jnp.sum(f * d, axis=-1)
    chord = f + b[..., None] * d
    discriminant = radius * radius - jnp.sum(chord * chord, axis=-1)
    c = jnp.sum(f * f, axis=-1) - radius * radius
    hit = discriminant >= 0.0
    sq = safe_sqrt(discriminant)
    q = jnp.where(b < 0.0, b - sq, b + sq)
    t0 = c / jnp.where(jnp.abs(q) < 1e-12, 1e-12, q)
    t1 = q
    lo = jnp.minimum(t0, t1)
    hi = jnp.maximum(t0, t1)
    return hit, jnp.where(hit, lo, 0.0), jnp.where(hit, hi, 0.0)


def phase_rayleigh(cosine):
    return 3.0 / (16.0 * PI) * (1.0 + cosine * cosine)


def phase_mie(cosine, g=0.8):
    num = (1.0 - g * g) * (1.0 + cosine * cosine)
    den = (2.0 + g * g) * jnp.power(
        jnp.maximum(1.0 + g * g - 2.0 * g * cosine, 1e-12), 1.5
    )
    return 3.0 / (8.0 * PI) * num / den


def raycast_atmosphere(atmo, origin, direction):
    """``raycastAtmosphere`` (``common.glinl:284-307``) -> distance through."""
    hit_a, a0, a1 = ray_sphere_intersect(
        origin, direction, atmo.atmosphere_radius_mm
    )
    hit_atmo = hit_a & (a1 > 0.0)
    a0 = jnp.maximum(0.0, a0)
    hit_p, p0, _ = ray_sphere_intersect(origin, direction, atmo.planet_radius_mm)
    hit_planet = hit_p & (p0 > 0.0)
    a1 = jnp.where(hit_planet, jnp.minimum(p0, a1), a1)
    return jnp.where(hit_atmo, a1 - a0, 0.0)


class RaymarchStep(NamedTuple):
    radius: jnp.ndarray
    mu: jnp.ndarray
    mu_sun: jnp.ndarray


def step_radius_mu(start: RaymarchStep, step_distance) -> RaymarchStep:
    """``stepRadiusMu`` (``common.glinl:316-334``)."""
    mu_sun_step = safe_sqrt(
        start.mu_sun * start.mu
        - safe_sqrt((1.0 - start.mu_sun * start.mu_sun) * (1.0 - start.mu * start.mu))
    )
    radius = safe_sqrt(
        step_distance * step_distance
        + 2.0 * start.radius * start.mu * step_distance
        + start.radius * start.radius
    )
    safe_radius = jnp.maximum(radius, 1e-12)
    return RaymarchStep(
        radius=radius,
        mu=(start.radius * start.mu + step_distance) / safe_radius,
        mu_sun=(start.radius * start.mu_sun + step_distance * mu_sun_step)
        / safe_radius,
    )


def sample_transmittance_raymarch_step(atmo, lut, start: RaymarchStep, step_distance):
    """``sampleTransmittanceLUT_RayMarchStep`` (``common.glinl:336-361``).

    Kept as the 1:1 port of the reference function; the production
    integrals inline an equivalent form with the step-invariant origin
    sample hoisted out of the loop (see
    :func:`luminance_scattering_integral`)."""
    end = step_radius_mu(start, step_distance)
    up = start.mu > 0.0
    a_r = jnp.where(up, start.radius, end.radius)
    a_mu = jnp.where(up, start.mu, -end.mu)
    b_r = jnp.where(up, end.radius, start.radius)
    b_mu = jnp.where(up, end.mu, -start.mu)
    transmittance = sample_transmittance_rmu(lut, atmo, a_r, a_mu) / jnp.maximum(
        sample_transmittance_rmu(lut, atmo, b_r, b_mu), 1e-20
    )
    transmittance = jnp.clip(transmittance, 0.0, 1.0)
    tiny = (step_distance < 1e-7)[..., None]
    return jnp.where(tiny, 1.0, transmittance)


def luminance_scattering_integral(
    atmo: AtmospherePacked,
    lut: jnp.ndarray,
    origin: jnp.ndarray,  # (..., 3)
    direction: jnp.ndarray,  # (..., 3) normalized-ish
    sample_distance: jnp.ndarray,  # (...)
) -> jnp.ndarray:
    """``computeLuminanceScatteringIntegral`` (``common.glinl:363-424``)."""
    scattering_dir = -direction / _norm(direction)
    radius = _norm(origin)[..., 0]
    mu = jnp.sum(origin * direction, axis=-1) / (
        radius * _norm(direction)[..., 0]
    )
    sun = atmo.incident_direction_sun
    mu_sun = jnp.sum(origin * (-sun), axis=-1) / (radius * jnp.linalg.norm(sun))
    origin_step = RaymarchStep(radius, mu, mu_sun)

    d_sample = sample_distance / SKYVIEW_SAMPLES
    incident_cos = jnp.sum(sun * scattering_dir, axis=-1)
    phase_r = phase_rayleigh(incident_cos)[..., None]
    phase_m = phase_mie(incident_cos, 0.8)[..., None]

    # Hoisted half of sampleTransmittanceLUT_RayMarchStep: its `up` branch
    # is fixed per ray (start.mu sign), so the origin-side sample of the
    # ratio is step-invariant — sample both orientations once here and per
    # step only the end point (1 gather instead of 2, identical values).
    up = (origin_step.mu > 0.0)[..., None]
    t_start_up = sample_transmittance_rmu(
        lut, atmo, origin_step.radius, origin_step.mu
    )
    t_start_dn = sample_transmittance_rmu(
        lut, atmo, origin_step.radius, -origin_step.mu
    )

    def body(i, luminance):
        t = i * d_sample
        begin = origin - (i * d_sample)[..., None] * scattering_dir
        end = origin - ((i + 1.0) * d_sample)[..., None] * scattering_dir
        sample_step = step_radius_mu(origin_step, t)
        altitude = _norm(begin)[..., 0] - atmo.planet_radius_mm
        t_sun = sample_transmittance_sun(lut, atmo, sample_step.radius, sample_step.mu_sun)
        ext = sample_extinction(atmo, altitude)
        s_end = sample_transmittance_rmu(
            lut,
            atmo,
            sample_step.radius,
            jnp.where(up[..., 0], sample_step.mu, -sample_step.mu),
        )
        t_begin = jnp.clip(
            jnp.where(
                up,
                t_start_up / jnp.maximum(s_end, 1e-20),
                s_end / jnp.maximum(t_start_dn, 1e-20),
            ),
            0.0,
            1.0,
        )
        t_begin = jnp.where((t < 1e-7)[..., None], 1.0, t_begin)
        phase_scat = ext.scattering_rayleigh * phase_r + ext.scattering_mie * phase_m
        t_path = sample_transmittance_segment(lut, atmo, begin, end)
        integral = (1.0 - t_path) / jnp.maximum(ext.extinction, 1e-12)
        return luminance + phase_scat * t_sun * integral * t_begin

    shape = (*sample_distance.shape, 3)
    return jax.lax.fori_loop(
        0,
        SKYVIEW_SAMPLES,
        lambda i, lum: body(jnp.float32(i), lum),
        match_vma(jnp.zeros(shape, jnp.float32), atmo, lut, sample_distance),
    )


def luminance_scattering_integral_fast(
    atmo: AtmospherePacked,
    lut: jnp.ndarray,
    origin: jnp.ndarray,  # (..., 3)
    direction: jnp.ndarray,  # (..., 3) normalized-ish
    sample_distance: jnp.ndarray,  # (...)
) -> jnp.ndarray:
    """Optimized single-scattering integral (Hillaire production form).

    Same 32 sample points and phase/extinction math as
    :func:`luminance_scattering_integral`, but the path transmittances are
    ACCUMULATED analytically — ``T(0->t_i)`` as a running product of
    ``exp(-extinction * dt)`` and the per-step ``(1 - T_step)/extinction``
    factor from the same exponential — instead of 4 transmittance-LUT
    ratios per step (``common.glinl:336-361`` + ``:114-136``). Only the
    per-step SUN transmittance still samples the LUT (irreducible: it
    leaves the view ray). This is the formulation of Hillaire's production
    shader.

    NOT parity-exact: with 32 samples the steps span tens of km (≫ the 8 km
    Rayleigh scale height), where the exponential-of-point-extinction step
    underestimates what the LUT ratio integrates exactly — measured skyview
    deviation up to ~0.012 absolute / ~1e-3 RMSE in luminance (before the
    x10 display scaling), see tests/test_atmosphere.py::test_fast_integral.
    Opt-in speed mode (``RenderConfig.fast_sky``), off by default.

    Per-pixel cost drops from 5 bilinear LUT gathers per step to 1.
    """
    scattering_dir = -direction / _norm(direction)
    radius = _norm(origin)[..., 0]
    mu = jnp.sum(origin * direction, axis=-1) / (
        radius * _norm(direction)[..., 0]
    )
    sun = atmo.incident_direction_sun
    mu_sun = jnp.sum(origin * (-sun), axis=-1) / (radius * jnp.linalg.norm(sun))
    origin_step = RaymarchStep(radius, mu, mu_sun)

    d_sample = sample_distance / SKYVIEW_SAMPLES
    incident_cos = jnp.sum(sun * scattering_dir, axis=-1)
    phase_r = phase_rayleigh(incident_cos)[..., None]
    phase_m = phase_mie(incident_cos, 0.8)[..., None]

    shape = (*sample_distance.shape, 3)

    def body(i, carry):
        luminance, t_acc = carry
        t = i * d_sample
        begin = origin - (i * d_sample)[..., None] * scattering_dir
        sample_step = step_radius_mu(origin_step, t)
        altitude = _norm(begin)[..., 0] - atmo.planet_radius_mm
        t_sun = sample_transmittance_sun(
            lut, atmo, sample_step.radius, sample_step.mu_sun
        )
        ext = sample_extinction(atmo, altitude)
        t_step = jnp.exp(-d_sample[..., None] * ext.extinction)
        phase_scat = (
            ext.scattering_rayleigh * phase_r + ext.scattering_mie * phase_m
        )
        integral = (1.0 - t_step) / jnp.maximum(ext.extinction, 1e-12)
        luminance = luminance + phase_scat * t_sun * integral * t_acc
        return luminance, t_acc * t_step

    luminance, _ = jax.lax.fori_loop(
        0,
        SKYVIEW_SAMPLES,
        lambda i, c: body(jnp.float32(i), c),
        match_vma(
            (jnp.zeros(shape, jnp.float32), jnp.ones(shape, jnp.float32)),
            atmo,
            lut,
            sample_distance,
        ),
    )
    return luminance


@functools.partial(jax.jit, static_argnames=("width", "height"))
def compute_transmittance_lut(
    atmo: AtmospherePacked,
    width: int = TRANSMITTANCE_W,
    height: int = TRANSMITTANCE_H,
) -> jnp.ndarray:
    """``transmittance_LUT.comp``: (height, width, 3) f32, 500-sample optical
    depth. Reference dims 512x128 (``common.glinl:13``); smaller dims are a
    closeness-bounded fast mode (the field is smooth — see
    ``tests/test_atmosphere.py::test_transmittance_lut_downsample_close``).
    The half-texel UV insets follow ``width``/``height``, and every sampler
    derives them from the LUT object, so any dims are self-consistent."""
    u = (jnp.arange(width, dtype=jnp.float32) + 0.5) / width
    v = (jnp.arange(height, dtype=jnp.float32) + 0.5) / height
    uu, vv = jnp.meshgrid(u, v)  # (H, W)
    radius, mu = transmittance_uv_to_rmu(atmo, uu, vv, width, height)

    origin = jnp.stack(
        [jnp.zeros_like(radius), radius, jnp.zeros_like(radius)], axis=-1
    )
    direction = jnp.stack(
        [safe_sqrt(1.0 - mu * mu), mu, jnp.zeros_like(mu)], axis=-1
    )
    hit, _, t1 = ray_sphere_intersect(origin, direction, atmo.atmosphere_radius_mm)
    distance = t1
    dt = distance / TRANSMITTANCE_SAMPLES

    def body(i, transmittance):
        t = distance * (i + 0.5) / TRANSMITTANCE_SAMPLES
        position = origin + t[..., None] * direction
        altitude = _norm(position)[..., 0] - atmo.planet_radius_mm
        ext = sample_extinction(atmo, altitude)
        return transmittance * jnp.exp(-jnp.abs(dt)[..., None] * ext.extinction)

    transmittance = jax.lax.fori_loop(
        0,
        TRANSMITTANCE_SAMPLES,
        lambda i, tr: body(jnp.float32(i), tr),
        match_vma(jnp.ones((height, width, 3), jnp.float32), atmo),
    )
    return jnp.where(hit[..., None], transmittance, 1.0)


def _scattering_integral_components(atmo, lut, origin, direction, sample_distance):
    """The reference scattering integral with the phase functions factored
    out: returns (A_rayleigh, A_mie) with
    ``luminance = phase_r * A_rayleigh + phase_m * A_mie``.

    Same per-step terms as :func:`luminance_scattering_integral` (including
    the hoisted raymarch ratio); only the summation is distributed over the
    two phase channels, so results differ from the fused form at the
    float-rounding level."""
    scattering_dir = -direction / _norm(direction)
    radius = _norm(origin)[..., 0]
    mu = jnp.sum(origin * direction, axis=-1) / (
        radius * _norm(direction)[..., 0]
    )
    sun = atmo.incident_direction_sun
    mu_sun = jnp.sum(origin * (-sun), axis=-1) / (radius * jnp.linalg.norm(sun))
    origin_step = RaymarchStep(radius, mu, mu_sun)

    d_sample = sample_distance / SKYVIEW_SAMPLES
    up = (origin_step.mu > 0.0)[..., None]
    t_start_up = sample_transmittance_rmu(
        lut, atmo, origin_step.radius, origin_step.mu
    )
    t_start_dn = sample_transmittance_rmu(
        lut, atmo, origin_step.radius, -origin_step.mu
    )

    def body(i, carry):
        acc_r, acc_m = carry
        t = i * d_sample
        begin = origin - (i * d_sample)[..., None] * scattering_dir
        end = origin - ((i + 1.0) * d_sample)[..., None] * scattering_dir
        sample_step = step_radius_mu(origin_step, t)
        altitude = _norm(begin)[..., 0] - atmo.planet_radius_mm
        t_sun = sample_transmittance_sun(
            lut, atmo, sample_step.radius, sample_step.mu_sun
        )
        ext = sample_extinction(atmo, altitude)
        s_end = sample_transmittance_rmu(
            lut,
            atmo,
            sample_step.radius,
            jnp.where(up[..., 0], sample_step.mu, -sample_step.mu),
        )
        t_begin = jnp.clip(
            jnp.where(
                up,
                t_start_up / jnp.maximum(s_end, 1e-20),
                s_end / jnp.maximum(t_start_dn, 1e-20),
            ),
            0.0,
            1.0,
        )
        t_begin = jnp.where((t < 1e-7)[..., None], 1.0, t_begin)
        t_path = sample_transmittance_segment(lut, atmo, begin, end)
        integral = (1.0 - t_path) / jnp.maximum(ext.extinction, 1e-12)
        common = t_sun * integral * t_begin
        return (
            acc_r + ext.scattering_rayleigh * common,
            acc_m + ext.scattering_mie * common,
        )

    shape = (*sample_distance.shape, 3)
    zero = match_vma(
        jnp.zeros(shape, jnp.float32), atmo, lut, sample_distance
    )
    return jax.lax.fori_loop(
        0, SKYVIEW_SAMPLES, lambda i, c: body(jnp.float32(i), c), (zero, zero)
    )


@functools.partial(
    jax.jit, static_argnames=("width", "height", "fast", "rowwise")
)
def compute_skyview_lut(
    atmo: AtmospherePacked,
    origin_mm: jnp.ndarray,  # (3,) camera position, sky space (+y up, Mm)
    transmittance_lut: jnp.ndarray,
    width: int = SKYVIEW_W,
    height: int = SKYVIEW_H,
    fast: bool = False,
    rowwise: bool = True,
) -> jnp.ndarray:
    """``skyview_LUT.comp``: lat-long in-scattering map (height, width, 3).

    ``rowwise`` (default) exploits the structure of the reference's own
    integral: with the camera origin on the planet-center axis, every
    per-step term — radii, extinctions, the transmittance ratios, and even
    the sun transmittance (``stepRadiusMu``'s mu_sun derives only from the
    origin's scalar mu_sun and the row's view mu, ``common.glinl:316-334``)
    — depends only on the LUT ROW (elevation). The 2-million-texel build
    collapses to ``height`` row integrals plus a per-texel phase-function
    combination: ~2000x fewer LUT gathers. Deviations vs the per-texel
    build: the origin is projected onto the axis (|xz|/planet_radius ~ 1e-5
    relative for meter-scale scenes — the SAMPLER's direction->v mapping
    assumes an on-axis origin anyway, ``camera.comp:70-121``) and the
    phase factors distribute over the step sum (float-rounding level).
    Measured against the per-texel build in
    tests/test_atmosphere.py::test_skyview_rowwise_close."""
    u = (jnp.arange(width, dtype=jnp.float32) + 0.5) / width
    v = (jnp.arange(height, dtype=jnp.float32) + 0.5) / height
    uu, vv = jnp.meshgrid(u, v)

    radius = jnp.linalg.norm(origin_mm)
    sin_horizon = atmo.planet_radius_mm / radius
    horizon_zenith = PI - jnp.arcsin(jnp.clip(sin_horizon, -1.0, 1.0))

    # azimuth (skyview_LUT.comp:58-69)
    cos_view_light = (uu - 0.5) * 2.0
    light_proj = -jnp.stack(
        [atmo.incident_direction_sun[0], atmo.incident_direction_sun[2]]
    )
    light_proj = light_proj / jnp.maximum(jnp.linalg.norm(light_proj), 1e-12)
    azimuth_sun = jnp.arcsin(jnp.clip(light_proj[0], -1.0, 1.0))
    azimuth_sun = jnp.where(light_proj[1] < 0.0, PI - azimuth_sun, azimuth_sun)
    azimuth = jnp.arccos(jnp.clip(cos_view_light, -1.0, 1.0)) + azimuth_sun

    # elevation (skyview_LUT.comp:71-88)
    unnorm = 2.0 * vv - 1.0
    above = vv < 0.5
    frac_above = 1.0 - unnorm * unnorm
    frac_below = unnorm * unnorm
    view_zenith = jnp.where(
        above,
        frac_above * horizon_zenith,
        (PI - horizon_zenith) * frac_below + horizon_zenith,
    )
    elevation = -(view_zenith - PI / 2.0)

    direction = jnp.stack(
        [
            jnp.sin(azimuth) * jnp.cos(elevation),
            jnp.sin(elevation),
            jnp.cos(azimuth) * jnp.cos(elevation),
        ],
        axis=-1,
    )
    if rowwise and not fast:
        radius_o = jnp.linalg.norm(origin_mm)
        elev_row = elevation[:, :1]  # elevation is row-constant by build
        dir_row = jnp.stack(
            [
                jnp.zeros_like(elev_row),
                jnp.sin(elev_row),
                jnp.cos(elev_row),
            ],
            axis=-1,
        )  # (h, 1, 3)
        origin_row = jnp.broadcast_to(
            jnp.stack(
                [
                    jnp.zeros_like(radius_o),
                    radius_o,
                    jnp.zeros_like(radius_o),
                ]
            ),
            dir_row.shape,
        )
        dist_row = raycast_atmosphere(atmo, origin_row, dir_row)
        a_r, a_m = _scattering_integral_components(
            atmo, transmittance_lut, origin_row, dir_row, dist_row
        )
        sun = atmo.incident_direction_sun
        incident_cos = jnp.sum(sun * (-direction), axis=-1)
        phase_r = phase_rayleigh(incident_cos)[..., None]
        phase_m = phase_mie(incident_cos, 0.8)[..., None]
        return phase_r * a_r + phase_m * a_m

    origin = jnp.broadcast_to(origin_mm, direction.shape)
    distance = raycast_atmosphere(atmo, origin, direction)
    integral = (
        luminance_scattering_integral_fast
        if fast
        else luminance_scattering_integral
    )
    return integral(atmo, transmittance_lut, origin, direction, distance)

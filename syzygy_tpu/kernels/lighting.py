"""Deferred PBR lighting with PCF shadow maps.

Port of ``shaders/deferred/lights.comp`` (per-pixel light accumulation),
``shaders/gbuffer/pbrFunctions.glinl`` (BRDFs) and ``shaders/shadowmap.glinl``
(5x5 PCF, reverse-Z compare, NEAREST + clamp-to-border sampling —
``renderer/shadowpass.cpp:30-34``). All math is vectorized over the pixel
grid; the per-light loops are static-capacity with ``lax.cond`` so inactive
lights cost nothing.

Shadow-map index convention follows ``lights.comp:139-161`` /
``ShadowPassArray::recordInitialize`` (``shadowpass.cpp:188-248``): map k
belongs to light k in the concatenation [directional..., spot...].
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from syzygy_tpu.kernels.common import match_vma
from syzygy_tpu.kernels.resolve import GBuffer
from syzygy_tpu.scene.camera import CameraPacked
from syzygy_tpu.scene.lights import DirectionalLight, SpotLight

# mat4 TO_TEX_COORD_MAT (shadowmap.glinl:2-8), row-major math form
TO_TEX_COORD = jnp.array(
    [
        [0.5, 0.0, 0.0, 0.5],
        [0.0, 0.5, 0.0, 0.5],
        [0.0, 0.0, 1.0, 0.0],
        [0.0, 0.0, 0.0, 1.0],
    ],
    jnp.float32,
)

SPECULAR_POWER_BASE = 160.0  # pbrFunctions.glinl:5
DIELECTRIC_F0 = 0.04  # pbrFunctions.glinl:7
PI = 3.14159265359


class PBRTexel(NamedTuple):
    """``PBRTexel`` (``shaders/gbuffer/pbr.glinl``) over the pixel grid."""

    position: jnp.ndarray  # (H, W, 3)
    normal: jnp.ndarray  # (H, W, 3)
    subscattering_color: jnp.ndarray  # (H, W, 3)
    normal_reflectance: jnp.ndarray  # (H, W, 3)
    occlusion: jnp.ndarray  # (H, W, 1)
    specular_power: jnp.ndarray  # (H, W, 1)
    metallic: jnp.ndarray  # (H, W, 1)


def convert_pbr(gbuffer: GBuffer) -> PBRTexel:
    """``convertPBRProperties`` (``pbrFunctions.glinl:3-20``)."""
    spec_rgb = gbuffer.specular[..., :3]
    max3 = jnp.max(spec_rgb, axis=-1, keepdims=True)
    metallic_reflectance = 0.5 * spec_rgb / jnp.maximum(max3, 1e-8)
    metallic = gbuffer.orm[..., 2:3]
    roughness = gbuffer.orm[..., 1:2]
    return PBRTexel(
        position=gbuffer.world_position[..., :3],
        normal=gbuffer.normal[..., :3],
        subscattering_color=gbuffer.diffuse[..., :3],
        normal_reflectance=DIELECTRIC_F0 * (1.0 - metallic)
        + metallic_reflectance * metallic,
        occlusion=gbuffer.orm[..., 0:1],
        specular_power=jnp.power(SPECULAR_POWER_BASE, 1.0 - roughness),
        metallic=metallic,
    )


def _normalize(v, eps=1e-20):
    return v / jnp.sqrt(jnp.maximum(jnp.sum(v * v, axis=-1, keepdims=True), eps))


def _dot1(a, b):
    return jnp.sum(a * b, axis=-1, keepdims=True)


def compute_fresnel(material: PBRTexel, light_dir, view_dir) -> jnp.ndarray:
    """``computeFresnel`` (``pbrFunctions.glinl:22-32``), Schlick."""
    halfway = _normalize(light_dir + view_dir)
    hl = jnp.clip(_dot1(halfway, light_dir), 0.0, 1.0)
    f0 = material.normal_reflectance
    return f0 + (1.0 - f0) * jnp.power(1.0 - hl, 5.0)


def diffuse_brdf(material: PBRTexel) -> jnp.ndarray:
    """Lambert (``pbrFunctions.glinl:34-39``)."""
    return material.subscattering_color / PI


def specular_brdf(material: PBRTexel, light_dir, view_dir) -> jnp.ndarray:
    """Normalized Blinn-Phong (``pbrFunctions.glinl:41-52``)."""
    halfway = _normalize(light_dir + view_dir)
    hn = jnp.clip(_dot1(halfway, material.normal), 0.0, 1.0)
    spec_power = material.specular_power
    microfacet = jnp.power(hn, spec_power)
    normalization = (spec_power + 2.0) / 8.0
    return jnp.broadcast_to(
        normalization * microfacet, material.subscattering_color.shape
    )


def compute_shadow_frame(light_proj_view, position, normal):
    """``computeShadowFrame`` (``shadowmap.glinl:17-30``)."""
    m = TO_TEX_COORD @ light_proj_view  # (4, 4)
    pos_h = jnp.concatenate(
        [position, jnp.ones((*position.shape[:-1], 1), jnp.float32)], axis=-1
    )
    coord = pos_h @ m.T  # (H, W, 4)
    coord = coord / jnp.where(jnp.abs(coord[..., 3:4]) < 1e-8, 1e-8, coord[..., 3:4])
    n_h = jnp.concatenate([normal, jnp.zeros((*normal.shape[:-1], 1), jnp.float32)], axis=-1)
    pn = n_h @ m.T
    dx = jnp.sqrt(1.0 - jnp.clip(pn[..., 0] * pn[..., 0], 0.0, 1.0))
    dy = jnp.sqrt(1.0 - jnp.clip(pn[..., 1] * pn[..., 1], 0.0, 1.0))
    return coord, dx, dy


_PCF_PAD = 8  # border texels (clamp-to-border 0) + window alignment slack


_PCF_WINDOW_MAX_DIM = 2048  # windowed-segment table is O(dim^2 * 16)


def sample_shadow_map(
    shadow_map, coord, dx, dy, bitmask=False, f16=False, q8=False,
    window2d=False, seg8=False,
) -> jnp.ndarray:
    """``sampleShadowMap`` (``shadowmap.glinl:32-63``): 5x5 PCF, NEAREST,
    clamp-to-border(0), reverse-Z occluder test. Returns (H, W) light factor.

    Gather-lean formulation: the map is pre-windowed into overlapping
    16-texel row segments (stride 8), chosen so one segment covers all 5
    taps of a PCF row (tap offsets span <= 3 texels each way: |ox| <= 2,
    du <= 1.5/size — ``compute_shadow_frame`` guarantees dx, dy <= 1, so
    the window bound is exact over the valid domain). Each pixel then
    fetches 5 segments (one per tap row)
    instead of 25 single texels, and extracts tap results with a select
    tree (see inline comment). Values, masks and compares are
    bitwise-identical to the per-texel formulation (tests/test_lighting.py).

    Maps above 2048^2 use the direct per-texel form instead: the segment
    table costs 16 x dim^2 floats (2.2 GB per light at 4096^2, 36 GB at
    8192^2), while 25 single gathers need no side table. Identical
    results either way.

    ``f16=True`` stores the segment table in float16 (occluder depths
    round to ~5e-4 relative before the reverse-Z compare; taps whose
    occluder-receiver gap is below that can flip). Storage-precision-only
    fast mode, same shape as the skyview-quad f16 win; the quality bound
    is pinned by tests/test_lighting.py::test_pcf_f16_close.

    ``q8=True`` (takes precedence over ``f16``) block-quantizes each
    segment: 16 u8 taps relative to the segment's own [min, max] depth
    range packed into 4 uint32 words, plus the f16 min/step pair packed
    into a 5th word — 20 bytes/row vs f16's 32 on the frame's hottest
    tables (the PCF rows are 15 of its ~21 gathers/px). All byte
    extraction is by CONSTANT shifts; the select tree runs 2 levels on uint32
    words + 2 levels on extracted bytes. Error per tap <= segment depth
    range / 510 (+ f16 rounding of min/step): exactly 0-valued texels
    (map border / never-written) decode to exactly 0, so the
    ``occ > 0`` border test is preserved; flat segments decode near-
    exactly. Quality pinned by tests/test_lighting.py::
    test_pcf_q8_{close,frame_close}.

    ``window2d=True`` (ignored under ``q8``) swaps the five per-tap-row
    segment gathers for ONE 128-channel gather of an 8-row x 16-col 2D
    window table (see ``_pcf_window2d``). Bitwise-identical taps; one
    256 B row replaces five 32 B rows. Default off; not measured on the
    H100.

    ``seg8=True`` (ignored under ``q8``/``bitmask``) narrows the row
    segments 16 -> 8 channels at stride 2: same five gathers but HALF
    the fetched bytes (5 x 16 B f16) and a 3-level column tree, at a 2x
    side table (stride-2 windows duplicate each texel 4x). Bitwise-
    identical taps (tests/test_lighting.py::test_pcf_seg8_bitwise).
    Default off; not measured on the H100."""
    size = shadow_map.shape[-1]
    if size > _PCF_WINDOW_MAX_DIM:
        return _sample_shadow_map_naive(shadow_map, coord, dx, dy)
    frag_depth = coord[..., 2]
    du = 1.5 * dx / size
    dv = 1.5 * dy / size
    u = coord[..., 0]
    v = coord[..., 1]
    if window2d and not q8:
        return _pcf_window2d(
            shadow_map, size, frag_depth, u, v, du, dv, f16
        )
    if seg8 and not q8 and not bitmask:
        return _pcf_seg8(shadow_map, size, frag_depth, u, v, du, dv, f16)

    pad = _PCF_PAD
    n_w = (size + 2 * pad) // 8
    padded = jnp.zeros((size, n_w * 8 + 8), shadow_map.dtype)
    padded = padded.at[:, pad : pad + size].set(shadow_map)
    seg_idx = (jnp.arange(n_w) * 8)[:, None] + jnp.arange(16)[None, :]
    windows = padded[:, seg_idx].reshape(size * n_w, 16)  # (size*n_w, 16)
    if q8:
        return _pcf_q8(
            windows, size, n_w, pad, frag_depth, u, v, du, dv
        )
    if f16:
        # f16 rows flow through the gather AND the select tree (half the
        # bytes in both); each selected tap widens to f32 for the compare.
        windows = windows.astype(jnp.float16)

    base = jnp.floor(u * size).astype(jnp.int32)
    start = base - 3 + pad  # leftmost texel any tap can touch (padded x)
    w = jnp.clip(jnp.floor_divide(start, 8), 0, n_w - 1)

    if bitmask:
        # Bitmask tap extraction: compare ALL 16 window channels once per
        # row, pack the booleans into an int32 bitmask, extract each tap's
        # bit with a variable right-shift. Bitwise-identical to the select
        # tree (test_pcf_bitmask_matches_select_tree) and ~40% less
        # arithmetic on paper. Default off; not measured on the H100.
        bit_weights = (1 << jnp.arange(16, dtype=jnp.int32)).astype(
            jnp.float32
        )
        occluded = jnp.zeros_like(frag_depth)
        for oy in range(-2, 3):
            iy = jnp.floor((v + oy * dv) * size).astype(jnp.int32)
            iyc = jnp.clip(iy, 0, size - 1)
            row = windows[iyc * n_w + w]  # (..., 16): ONE gather per row
            cmp = (row > 0.0) & (row > frag_depth[..., None])  # (..., 16)
            bits = jnp.sum(
                cmp.astype(jnp.float32) * bit_weights, axis=-1
            ).astype(jnp.int32)
            iy_in = (iy >= 0) & (iy < size)
            for ox in range(-2, 3):
                ix = jnp.floor((u + ox * du) * size).astype(jnp.int32)
                inside = iy_in & (ix >= 0) & (ix < size)
                c = jnp.clip(ix + pad - 8 * w, 0, 15)  # channel in segment
                bit = jnp.right_shift(bits, c) & 1
                occluded += jnp.where(inside, bit.astype(jnp.float32), 0.0)
        return 1.0 - occluded / 25.0

    select16 = _select16

    occluded = jnp.zeros_like(frag_depth)
    for oy in range(-2, 3):
        iy = jnp.floor((v + oy * dv) * size).astype(jnp.int32)
        iyc = jnp.clip(iy, 0, size - 1)
        row = windows[iyc * n_w + w]  # (..., 16): ONE gather per tap row
        for ox in range(-2, 3):
            ix = jnp.floor((u + ox * du) * size).astype(jnp.int32)
            inside = (ix >= 0) & (ix < size) & (iy >= 0) & (iy < size)
            c = jnp.clip(ix + pad - 8 * w, 0, 15)  # tap channel in segment
            tap = select16(row, c).astype(jnp.float32)
            occ_depth = jnp.where(inside, tap, 0.0)
            occluded += jnp.where(
                (occ_depth > 0.0) & (occ_depth > frag_depth), 1.0, 0.0
            )
    return 1.0 - occluded / 25.0


def _select16(row, c):
    """row[..., c] via a 4-level binary select tree (a quarter of the
    selects of a 16-wide one-hot). Out-of-range c picks an arbitrary
    finite channel —
    such taps are outside the map and masked by the caller's `inside`."""
    r = jnp.where((c & 8)[..., None] != 0, row[..., 8:], row[..., :8])
    r = jnp.where((c & 4)[..., None] != 0, r[..., 4:], r[..., :4])
    r = jnp.where((c & 2)[..., None] != 0, r[..., 2:], r[..., :2])
    return jnp.where((c & 1) != 0, r[..., 1], r[..., 0])


_PCF_PAD_Y = 8  # zero rows above the 2D-window table (anchor slack)


def _pcf_window2d(shadow_map, size, frag_depth, u, v, du, dv, f16):
    """2D-window PCF: ONE gather per pixel instead of five.

    The map is pre-windowed into 8-row x 16-col blocks — columns at the
    existing stride 8 (one block column covers all 5 column taps, exactly
    as ``sample_shadow_map``'s 1D segments), rows at STRIDE 2. Row
    coverage proof: the 5 tap rows floor((v + oy*dv)*size), |oy| <= 2,
    span at most 7 consecutive rows (|oy*dv*size| = |1.5*oy*dy| <= 3
    since compute_shadow_frame guarantees dy <= 1), and an 8-row window
    anchored at 2*floor((base_y - 3 + pad_y)/2) always contains
    [base_y - 3, base_y + 3] (slack 1 >= stride - 1). Each pixel gathers
    one (128,) block, extracts its 5 tap rows with a 3-level select tree
    over the row axis, then runs the unchanged 4-level column tree —
    taps are BITWISE-identical to the 1D-segment path
    (tests/test_lighting.py::test_pcf_window2d_bitwise).

    Trade: gather count 5 -> 1 per pixel, fetched bytes 160 -> 256 f16,
    side table 4.3 -> 17 MB at 1024^2 (stride 2 duplicates each texel 4x
    vs the 1D layout's 2x).
    """
    pad = _PCF_PAD
    pad_y = _PCF_PAD_Y
    n_w = (size + 2 * pad) // 8
    n_h = (size + 2 * pad_y) // 2
    padded = jnp.zeros((2 * (n_h - 1) + 8, n_w * 8 + 8), shadow_map.dtype)
    padded = padded.at[pad_y : pad_y + size, pad : pad + size].set(
        shadow_map
    )
    # Channel layout: flat 128 = window-row j (0..7) * 16 + column c
    # (0..15). Built from 128 STRIDED SLICES (channel (j, c) over the
    # (n_h, n_w) window grid is exactly padded[j::2, c::8]) — pure
    # slice+stack, no gather, so it hoists/fuses trivially. All
    # per-pixel shapes keep flat 128/64/32/16 trailing dims.
    blocks = jnp.stack(
        [
            padded[j : j + 2 * n_h : 2, c : c + 8 * n_w : 8]
            for j in range(8)
            for c in range(16)
        ],
        axis=-1,
    ).reshape(n_h * n_w, 8 * 16)
    if f16:
        # same placement as the 1D path: f16 flows through the gather and
        # both select trees; each selected tap widens for the compare
        blocks = blocks.astype(jnp.float16)

    base_x = jnp.floor(u * size).astype(jnp.int32)
    wx = jnp.clip(jnp.floor_divide(base_x - 3 + pad, 8), 0, n_w - 1)
    base_y = jnp.floor(v * size).astype(jnp.int32)
    wy = jnp.clip(jnp.floor_divide(base_y - 3 + pad_y, 2), 0, n_h - 1)

    block = blocks[wy * n_w + wx]  # (..., 128): the ONE gather

    def select_row(r):
        """block channels [16r, 16r+16) via a 3-level select tree on the
        FLAT channel axis (widths 64/32/16 — never a sub-128 tile).
        Out-of-range r (edge-clipped taps) picks an arbitrary row —
        masked by `inside` below, like the column tree's c."""
        t = jnp.where((r & 4)[..., None] != 0, block[..., 64:], block[..., :64])
        t = jnp.where((r & 2)[..., None] != 0, t[..., 32:], t[..., :32])
        return jnp.where((r & 1)[..., None] != 0, t[..., 16:], t[..., :16])

    occluded = jnp.zeros_like(frag_depth)
    for oy in range(-2, 3):
        iy = jnp.floor((v + oy * dv) * size).astype(jnp.int32)
        iyc = jnp.clip(iy, 0, size - 1)
        row = select_row(jnp.clip(iyc + pad_y - 2 * wy, 0, 7))
        for ox in range(-2, 3):
            ix = jnp.floor((u + ox * du) * size).astype(jnp.int32)
            inside = (ix >= 0) & (ix < size) & (iy >= 0) & (iy < size)
            c = jnp.clip(ix + pad - 8 * wx, 0, 15)  # tap channel in block
            tap = _select16(row, c).astype(jnp.float32)
            occ_depth = jnp.where(inside, tap, 0.0)
            occluded += jnp.where(
                (occ_depth > 0.0) & (occ_depth > frag_depth), 1.0, 0.0
            )
    return 1.0 - occluded / 25.0


def _pcf_seg8(shadow_map, size, frag_depth, u, v, du, dv, f16):
    """Narrow-segment PCF: 8-channel row windows at stride 2.

    Same shape as the default 16-channel/stride-8 segments, but each of
    the five row gathers fetches HALF the bytes (16 B f16) and the
    column extract is a 3-level tree (widths 4/2/1). Coverage proof: the
    5 column taps floor((u + ox*du)*size) span <= 7 texels (|ox*du*size|
    = |1.5*ox*dx| <= 3); an 8-texel window anchored at
    2*floor((base - 3 + pad)/2) always contains [base - 3, base + 3]
    (slack 1 >= stride - 1). The side table doubles (stride-2 windows
    hold each texel 4x vs stride-8's 2x): (size * n_w, 8) with
    n_w = (size + 2*pad)/2. Taps/masks/compares are bitwise-identical to
    the other formulations."""
    pad = _PCF_PAD
    n_w = (size + 2 * pad) // 2
    padded = jnp.zeros((size, 2 * (n_w - 1) + 8), shadow_map.dtype)
    padded = padded.at[:, pad : pad + size].set(shadow_map)
    seg_idx = (jnp.arange(n_w) * 2)[:, None] + jnp.arange(8)[None, :]
    windows = padded[:, seg_idx].reshape(size * n_w, 8)
    if f16:
        windows = windows.astype(jnp.float16)

    base = jnp.floor(u * size).astype(jnp.int32)
    w = jnp.clip(jnp.floor_divide(base - 3 + pad, 2), 0, n_w - 1)

    def select8(row, c):
        """row[..., c], 3-level tree; out-of-range c picks an arbitrary
        finite channel — such taps are masked by `inside` below."""
        r = jnp.where((c & 4)[..., None] != 0, row[..., 4:], row[..., :4])
        r = jnp.where((c & 2)[..., None] != 0, r[..., 2:], r[..., :2])
        return jnp.where((c & 1) != 0, r[..., 1], r[..., 0])

    occluded = jnp.zeros_like(frag_depth)
    for oy in range(-2, 3):
        iy = jnp.floor((v + oy * dv) * size).astype(jnp.int32)
        iyc = jnp.clip(iy, 0, size - 1)
        row = windows[iyc * n_w + w]  # (..., 8): ONE gather per tap row
        for ox in range(-2, 3):
            ix = jnp.floor((u + ox * du) * size).astype(jnp.int32)
            inside = (ix >= 0) & (ix < size) & (iy >= 0) & (iy < size)
            c = jnp.clip(ix + pad - 2 * w, 0, 7)  # tap channel in segment
            tap = select8(row, c).astype(jnp.float32)
            occ_depth = jnp.where(inside, tap, 0.0)
            occluded += jnp.where(
                (occ_depth > 0.0) & (occ_depth > frag_depth), 1.0, 0.0
            )
    return 1.0 - occluded / 25.0


def _pcf_q8(windows, size, n_w, pad, frag_depth, u, v, du, dv) -> jnp.ndarray:
    """u8 block-scaled PCF segment path (see ``sample_shadow_map`` q8 doc).

    Row layout (5 uint32 = 20 B): words[0..3] hold the 16 taps as u8
    fractions of the segment's own [min, max] depth range (tap j lives in
    word j>>2, byte j&3); word 4 packs the f16 min (low half) and f16
    step = range/255 (high half). Quantization runs on device per frame
    (elementwise work)."""
    lo = jnp.min(windows, axis=-1, keepdims=True)
    hi = jnp.max(windows, axis=-1, keepdims=True)
    # quantize against the f16-ROUNDED decode params so the u8 grid and
    # the decode grid agree; exact zeros stay exact (f16(0) == 0).
    lo16 = lo.astype(jnp.float16)
    step16 = ((hi - lo) * (1.0 / 255.0)).astype(jnp.float16)
    step = jnp.maximum(step16.astype(jnp.float32), 1e-30)
    q = jnp.clip(
        jnp.round((windows - lo16.astype(jnp.float32)) / step), 0.0, 255.0
    ).astype(jnp.uint32)
    shifts = jnp.array([0, 8, 16, 24], jnp.uint32)
    words = jnp.sum(
        q.reshape(-1, 4, 4) << shifts[None, None, :], axis=-1
    )  # (R, 4) uint32
    meta = jax.lax.bitcast_convert_type(lo16[:, 0], jnp.uint16).astype(
        jnp.uint32
    ) | (
        jax.lax.bitcast_convert_type(step16[:, 0], jnp.uint16).astype(
            jnp.uint32
        )
        << jnp.uint32(16)
    )
    rows = jnp.concatenate([words, meta[:, None]], axis=-1)  # (R, 5)

    base = jnp.floor(u * size).astype(jnp.int32)
    start = base - 3 + pad  # leftmost texel any tap can touch (padded x)
    w = jnp.clip(jnp.floor_divide(start, 8), 0, n_w - 1)

    def tap_byte(g, c):
        """taps[c] from the 4 packed words: 2 select levels on uint32
        words (c>>2), then CONSTANT byte shifts + 2 select levels (c&3).
        No per-lane variable shift anywhere (the bitmask lesson)."""
        r = jnp.where((c & 8)[..., None] != 0, g[..., 2:4], g[..., 0:2])
        word = jnp.where((c & 4) != 0, r[..., 1], r[..., 0])
        b01 = jnp.where((c & 1) != 0, word >> jnp.uint32(8), word)
        b23 = jnp.where(
            (c & 1) != 0, word >> jnp.uint32(24), word >> jnp.uint32(16)
        )
        return jnp.where((c & 2) != 0, b23, b01) & jnp.uint32(255)

    occluded = jnp.zeros_like(frag_depth)
    for oy in range(-2, 3):
        iy = jnp.floor((v + oy * dv) * size).astype(jnp.int32)
        iyc = jnp.clip(iy, 0, size - 1)
        g = rows[iyc * n_w + w]  # (..., 5) uint32: ONE gather per tap row
        meta_g = g[..., 4]
        lo_g = jax.lax.bitcast_convert_type(
            (meta_g & jnp.uint32(0xFFFF)).astype(jnp.uint16), jnp.float16
        ).astype(jnp.float32)
        st_g = jax.lax.bitcast_convert_type(
            (meta_g >> jnp.uint32(16)).astype(jnp.uint16), jnp.float16
        ).astype(jnp.float32)
        iy_in = (iy >= 0) & (iy < size)
        for ox in range(-2, 3):
            ix = jnp.floor((u + ox * du) * size).astype(jnp.int32)
            inside = iy_in & (ix >= 0) & (ix < size)
            c = jnp.clip(ix + pad - 8 * w, 0, 15)  # tap channel in segment
            occ = lo_g + tap_byte(g[..., :4], c).astype(jnp.float32) * st_g
            occ_depth = jnp.where(inside, occ, 0.0)
            occluded += jnp.where(
                (occ_depth > 0.0) & (occ_depth > frag_depth), 1.0, 0.0
            )
    return 1.0 - occluded / 25.0


def _sample_shadow_map_naive(shadow_map, coord, dx, dy) -> jnp.ndarray:
    """Direct per-texel 5x5 PCF (``shadowmap.glinl:32-63`` 1:1): 25 single
    gathers, no side table — the large-map path (see sample_shadow_map).
    Bitwise-identical values/masks/compares to the windowed formulation."""
    size = shadow_map.shape[-1]
    frag_depth = coord[..., 2]
    du = 1.5 * dx / size
    dv = 1.5 * dy / size
    u = coord[..., 0]
    v = coord[..., 1]
    occluded = jnp.zeros_like(frag_depth)
    for oy in range(-2, 3):
        iy = jnp.floor((v + oy * dv) * size).astype(jnp.int32)
        iyc = jnp.clip(iy, 0, size - 1)
        for ox in range(-2, 3):
            ix = jnp.floor((u + ox * du) * size).astype(jnp.int32)
            inside = (ix >= 0) & (ix < size) & (iy >= 0) & (iy < size)
            occ_depth = jnp.where(
                inside, shadow_map[iyc, jnp.clip(ix, 0, size - 1)], 0.0
            )
            occluded += jnp.where(
                (occ_depth > 0.0) & (occ_depth > frag_depth), 1.0, 0.0
            )
    return 1.0 - occluded / 25.0


def _light_contribution(material, view_dir, light_dir, spectral):
    """``computeLightContribution`` (``lights.comp:93-108``)."""
    diffuse = diffuse_brdf(material)
    specular = specular_brdf(material, light_dir, view_dir)
    fresnel = compute_fresnel(material, light_dir, view_dir)
    brdf = diffuse * (1.0 - fresnel) + specular * fresnel
    nl = jnp.clip(_dot1(material.normal, light_dir), 0.0, 1.0)
    return material.occlusion * brdf * spectral * nl


def deferred_lighting(
    gbuffer: GBuffer,
    camera: CameraPacked,
    directional: DirectionalLight,  # stacked (D, ...)
    directional_count: jnp.ndarray,
    directional_skip: jnp.ndarray,
    spots: SpotLight,  # stacked (S, ...)
    spot_count: jnp.ndarray,
    shadow_maps: jnp.ndarray,  # (D + S, dim, dim) f32 depth
    unroll: bool = False,
    pcf_bitmask: bool = False,  # PCF tap extraction variant (sample_shadow_map)
    pcf_f16: bool = False,  # f16 PCF segment storage (sample_shadow_map)
    pcf_q8: bool = False,  # u8 block-scaled PCF segments (sample_shadow_map)
    pcf_window2d: bool = False,  # one-gather 2D windows (sample_shadow_map)
    shadowless_eps: float = 0.0,  # see RenderConfig.shadowless_strength_eps
    # (H, W) precomputed sun PCF visibility (RenderConfig.share_sun_pcf):
    # directional light 0's sample_shadow_map result, evaluated once by the
    # caller and shared with the sky pass (kernels/sky.py samples the
    # identical frame). When set, light 0's contribution is accumulated
    # OUTSIDE the directional loop from this buffer (a cond-in-loop
    # formulation can be flattened to a select that still samples) —
    # identical math, minus one full 5-row PCF
    # (differences are XLA reassociation noise; see
    # RenderConfig.share_sun_pcf).
    sun_shadow=None,
) -> jnp.ndarray:
    """``deferred/lights.comp`` main loop -> (H, W, 3) linear color.

    Background texels (diffuse alpha < 1) stay black; the sky pass fills them.

    ``unroll=True`` unrolls the light loops over every static slot guarded
    by ``lax.cond`` — needed for reverse-mode differentiation (the default
    dynamic-trip-count loops lower to while_loop, which has no VJP) at the
    cost of evaluating all 18 slots.

    ``shadowless_eps > 0`` is the dim-directional fast mode: a directional
    light whose peak spectral intensity max|color| * |strength| falls below
    ``eps`` TIMES the frame's total daylight-weighted directional intensity
    (every directional's intensity scaled by its own above-horizon factor
    clip(dot(WORLD_UP, dir_to_light), 0, 1) — this INCLUDES the sky-handled
    sun, which is the illumination the skipped shadows hide under)
    contributes UNSHADOWED (a separate PCF-free loop skips its whole 5x5
    PCF structurally — the
    stage's dominant cost). Motivation: the reference's clamp quirk
    (``scene.cpp:603-610``) keeps the moon active in full daylight at peak
    intensity 0.012 (0.02 strength x 0.6 color), paying a full PCF for a
    ~1% contribution. The RELATIVE gate is essential: the moon's intensity
    never exceeds 0.012, but at night it is the ONLY light — the total
    collapses to the moon itself, the ratio is 1, and its shadows render
    exactly (tests/test_lighting.py::test_shadowless_eps_keeps_night_moon_
    shadowed). Deviation is bounded by the skipped light's intensity in
    its occluded pixels, which daylight keeps off the OETF's steep dark
    segment (closeness-pinned by test_shadowless_eps_frame_close);
    0.0 is exact. Spot lights are
    never gated (local falloff; no daylight notion).
    """
    material = convert_pbr(gbuffer)
    lit_mask = gbuffer.diffuse[..., 3:4] >= 1.0
    view_dir = _normalize(
        camera.position[:3] - material.position
    )

    h, w = gbuffer.diffuse.shape[:2]
    # carry vma must match the loop bodies' (sharded inputs) under
    # shard_map(check_vma=True) — metadata-only, no-op single-chip
    total = match_vma(
        jnp.zeros((h, w, 3), jnp.float32), gbuffer, shadow_maps, directional
    )

    # Dynamic-trip-count loops so only ACTIVE lights execute: a lax.cond
    # per static slot may be flattened to a select that runs every slot's
    # 5x5 PCF, while a fori_loop with traced bounds lowers to while_loop
    # and executes exactly `count` iterations.
    n_dir = directional.strength.shape[0]

    if shadowless_eps > 0.0:
        from syzygy_tpu.math.geometry import WORLD_UP

        dir_intensity = jnp.max(
            jnp.abs(directional.color[:, :3]), axis=-1
        ) * jnp.abs(directional.strength)
        daylight = jnp.clip(
            jnp.sum(-directional.forward[:, :3] * WORLD_UP, axis=-1),
            0.0,
            1.0,
        )
        total_daylight = jnp.sum(dir_intensity * daylight)
        shadowless_cut = shadowless_eps * total_daylight
    else:
        shadowless_cut = None

    # NO lax.cond around PCF work anywhere below: a compiler may flatten a
    # cond whose branches are same-shaped into a select that executes
    # BOTH sides, silently un-doing the skip. Every skip is therefore
    # structural: the hoisted sun is accumulated OUTSIDE the
    # loop, and shadowed vs shadowless lights run in two separate
    # compacted loops whose bodies contain no sampling alternative.
    def dir_pcf(i):
        light = jax.tree.map(lambda x: x[i], directional)
        coord, dx, dy = compute_shadow_frame(
            light.projection @ light.view, material.position, material.normal
        )
        return sample_shadow_map(
            shadow_maps[i], coord, dx, dy, bitmask=pcf_bitmask,
            f16=pcf_f16, q8=pcf_q8, window2d=pcf_window2d,
        )

    def dir_contribution(i, shadow):
        light = jax.tree.map(lambda x: x[i], directional)
        light_dir = _normalize(-light.forward[:3])[None, None, :]
        spectral = (light.color[:3] * light.strength)[
            None, None, :
        ] * shadow[..., None]
        return _light_contribution(material, view_dir, light_dir, spectral)

    if shadowless_cut is not None:
        needs_pcf = dir_intensity >= shadowless_cut  # (n_dir,)
    else:
        needs_pcf = None

    def dir_body(i, total):
        shadow = dir_pcf(i)
        if needs_pcf is not None:
            # unroll path only (every slot runs anyway): mask, don't cond
            shadow = jnp.where(needs_pcf[i], shadow, 1.0)
        return total + dir_contribution(i, shadow)

    if unroll:
        for i in range(n_dir):
            active = (i >= directional_skip) & (i < directional_count)
            total = jax.lax.cond(
                active,
                lambda t, i=i: dir_body(jnp.int32(i), t),
                lambda t: t,
                total,
            )
    else:
        # Compact to lights that can contribute: a light whose
        # color*strength product is exactly 0 has a spectral term of 0
        # (the moon is 0 in daylight and vice versa, scene.cpp:603-610),
        # so skipping it is bitwise-identical (assuming finite BRDFs) —
        # and saves its whole 5x5 PCF (the stage's dominant cost). The
        # != test keeps negative-strength lights live. Stable argsort
        # keeps the surviving lights' accumulation order.
        ids = jnp.arange(n_dir, dtype=jnp.int32)
        emits = (
            jnp.max(jnp.abs(directional.color[:, :3]), axis=-1)
            * directional.strength
        ) != 0.0
        active = (
            (ids >= directional_skip) & (ids < directional_count) & emits
        )
        if sun_shadow is not None:
            # Hoisted sun (light 0): its PCF is the caller's shared
            # buffer, so accumulate it here — structurally outside the
            # loop — and drop slot 0 from the loop's active set. The sun
            # stays first in accumulation order (it led the stable argsort
            # whenever active). where (not arithmetic masking) so an
            # inactive sun contributes exactly 0 even against a non-finite
            # BRDF, matching the emits-skip semantics.
            sun_sh = sun_shadow
            if needs_pcf is not None:
                sun_sh = jnp.where(needs_pcf[0], sun_shadow, 1.0)
            total = total + jnp.where(
                active[0], dir_contribution(0, sun_sh), 0.0
            )
            active = active & (ids != 0)
        if needs_pcf is not None:
            shadowed = active & needs_pcf
            unshadowed = active & ~needs_pcf
        else:
            shadowed, unshadowed = active, None
        order = jnp.argsort(~shadowed, stable=True).astype(jnp.int32)
        total = jax.lax.fori_loop(
            0,
            jnp.sum(shadowed.astype(jnp.int32)),
            lambda k, t: dir_body(order[k], t),
            total,
        )
        if unshadowed is not None:
            # dim-directional fast mode: these lights contribute with
            # shadow == 1 and their loop body contains NO sampling — the
            # PCF skip cannot be flattened away. Runs after the shadowed
            # loop (reordering the float accumulation is inside the
            # mode's deviation budget; eps == 0.0 never reaches here).
            h_, w_ = material.position.shape[:2]
            ones = jnp.ones((h_, w_), jnp.float32)
            u_order = jnp.argsort(~unshadowed, stable=True).astype(jnp.int32)
            total = jax.lax.fori_loop(
                0,
                jnp.sum(unshadowed.astype(jnp.int32)),
                lambda k, t: t + dir_contribution(u_order[k], ones),
                total,
            )

    n_spot = spots.strength.shape[0]

    def spot_body(j, total):
        spot = jax.tree.map(lambda x: x[j], spots)
        light_pv = spot.projection @ spot.view
        coord, dx, dy = compute_shadow_frame(
            light_pv, material.position, material.normal
        )
        shadow = sample_shadow_map(
            shadow_maps[n_dir + j],
            coord,
            dx,
            dy,
            bitmask=pcf_bitmask,
            f16=pcf_f16,
            q8=pcf_q8,
            window2d=pcf_window2d,
        )
        light_dir = _normalize(-spot.forward[:3])[None, None, :]
        # quadratic falloff + UV edge softening (lights.comp:73-91)
        dist = jnp.linalg.norm(
            spot.position[:3] - material.position, axis=-1, keepdims=True
        )
        norm_dist = dist / spot.falloff_distance
        falloff = spot.falloff_factor * norm_dist * norm_dist
        uv_dist = jnp.clip(
            jnp.linalg.norm(coord[..., :2] - 0.5, axis=-1, keepdims=True)
            / 0.5,
            0.0,
            1.0,
        )
        edge_soften = 1.0 - uv_dist * uv_dist
        spectral = (
            (spot.color[:3] * spot.strength)[None, None, :]
            / jnp.maximum(falloff, 1e-8)
            * edge_soften
            * shadow[..., None]
        )
        return total + _light_contribution(
            material, view_dir, light_dir, spectral
        )

    if unroll:
        for j in range(n_spot):
            total = jax.lax.cond(
                j < spot_count,
                lambda t, j=j: spot_body(jnp.int32(j), t),
                lambda t: t,
                total,
            )
    else:
        jds = jnp.arange(n_spot, dtype=jnp.int32)
        s_emits = (
            jnp.max(jnp.abs(spots.color[:, :3]), axis=-1) * spots.strength
        ) != 0.0
        s_active = (jds < spot_count) & s_emits
        s_order = jnp.argsort(~s_active, stable=True).astype(jnp.int32)
        total = jax.lax.fori_loop(
            0,
            jnp.sum(s_active.astype(jnp.int32)),
            lambda j, t: spot_body(s_order[j], t),
            total,
        )

    return jnp.where(lit_mask, total, 0.0)

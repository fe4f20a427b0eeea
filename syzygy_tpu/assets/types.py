"""Host-side asset types: meshes, surfaces, materials, texture library.

Mirrors ``assets/assets.hpp:30-244`` (``Mesh``, ``GeometrySurface``,
``MaterialData``) and the texture registry half of ``AssetLibrary``.
Differences from the Vulkan reference (static shapes for XLA):

* Textures keep their native resolutions and are packed into ONE padded
  2D atlas ``(A_h, A_w, 4) float32`` (linear light) with a per-texture rect
  table, replacing descriptor sets — per-pixel sampling is a static-shape
  gather indexed by material id (see ``kernels.resolve.sample_atlas_repeat``).
* Meshes are SoA numpy arrays; GPU upload happens when a Scene is packed into
  the static-shape device batch (see ``syzygy_tpu.scene.pack``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np



@dataclasses.dataclass(frozen=True)
class MaterialData:
    """Texture ids for one surface (``renderer/material.hpp:16-24``)."""

    color: int
    normal: int
    orm: int


@dataclasses.dataclass(frozen=True)
class GeometrySurface:
    """Triangle range + material (``assets/assets.hpp`` GeometrySurface)."""

    first_tri: int
    tri_count: int
    material: MaterialData


@dataclasses.dataclass
class Mesh:
    """Indexed triangle mesh (``assets/assets.hpp`` Mesh), SoA host arrays."""

    positions: np.ndarray  # (V, 3) f32
    normals: np.ndarray  # (V, 3) f32
    uvs: np.ndarray  # (V, 2) f32
    colors: np.ndarray  # (V, 4) f32
    triangles: np.ndarray  # (T, 3) i32
    surfaces: list[GeometrySurface]
    name: str = "mesh"

    @property
    def vertex_bounds(self):
        """min/max corner pair (``Mesh::vertexBounds``)."""
        return self.positions.min(axis=0), self.positions.max(axis=0)

    def __post_init__(self):
        self.positions = np.ascontiguousarray(self.positions, np.float32)
        self.normals = np.ascontiguousarray(self.normals, np.float32)
        self.uvs = np.ascontiguousarray(self.uvs, np.float32)
        self.colors = np.ascontiguousarray(self.colors, np.float32)
        self.triangles = np.ascontiguousarray(self.triangles, np.int32)


def srgb_to_linear(srgb: np.ndarray) -> np.ndarray:
    """EOTF: inverse of the sRGB transfer in ``shaders/transfer/oetf_srgb.comp``."""
    srgb = srgb.astype(np.float32)
    return np.where(
        srgb <= 0.04045, srgb / 12.92, ((srgb + 0.055) / 1.055) ** 2.4
    ).astype(np.float32)


def linear_to_srgb(linear: np.ndarray) -> np.ndarray:
    """OETF: the sRGB transfer (``oetf_srgb.comp``), numpy host-side.

    Inverse of :func:`srgb_to_linear`; used when DISPLAYING stored
    linear-light texels (texture inspector / dumps) so color maps that were
    sRGB-decoded at register time round-trip back to their source pixel
    values instead of showing darker."""
    linear = np.clip(linear.astype(np.float32), 0.0, 1.0)
    return np.where(
        linear <= 0.0031308,
        linear * 12.92,
        1.055 * linear ** (1.0 / 2.4) - 0.055,
    ).astype(np.float32)


class TextureLibrary:
    """Registry of native-resolution float32 textures.

    Replaces the reference's per-image descriptor sets (``assets.cpp:470-575``
    decodes each glTF image at SOURCE resolution with a per-image sRGB/UNORM
    choice). Static-shape discipline: at pack time every texture is placed
    into ONE padded 2D atlas (:meth:`as_atlas`) so per-pixel sampling stays a
    static-shape gather; each texture keeps its own resolution and REPEAT
    wrapping via a per-texture rect table.

    ``max_size`` only CAPS oversized inputs (downsampled to fit); smaller
    textures are stored as-is.
    """

    def __init__(self, max_size: int = 1024):
        self.max_size = max_size
        self._textures: list[np.ndarray] = []
        self._names: dict[str, int] = {}
        self._srgb: list[bool] = []

    def register(
        self, name: str, rgba: np.ndarray, srgb: bool = False,
        replace: bool = False,
    ) -> int:
        """Add a texture; uint8 input is normalized, sRGB decoded if flagged.

        Mirrors the color/UNORM format split at ``assets.cpp:701-711`` (color
        maps are sRGB; normal/ORM maps are linear UNORM).

        An already-registered ``name`` returns its existing index untouched
        unless ``replace=True``, which re-decodes in place (same index, new
        texels + sRGB flag) — the runtime reload path: the reference's
        loadImageDialog re-reads the file every time.
        """
        if name in self._names and not replace:
            return self._names[name]
        img = np.asarray(rgba)
        if img.dtype == np.uint8:
            img = img.astype(np.float32) / 255.0
        img = img.astype(np.float32)
        if img.ndim != 3 or img.shape[2] != 4:
            raise ValueError(f"expected (H, W, 4) texture, got {img.shape}")
        if srgb:
            img = np.concatenate(
                [srgb_to_linear(img[..., :3]), img[..., 3:]], axis=-1
            )
        h, w = img.shape[:2]
        if max(h, w) > self.max_size:
            s = self.max_size / max(h, w)
            img = _resize_bilinear(
                img, max(int(round(h * s)), 1), max(int(round(w * s)), 1)
            )
        if name in self._names:  # replace=True reload: same index
            idx = self._names[name]
            self._textures[idx] = np.ascontiguousarray(img, np.float32)
            self._srgb[idx] = srgb
            return idx
        idx = len(self._textures)
        self._textures.append(np.ascontiguousarray(img, np.float32))
        self._names[name] = idx
        self._srgb.append(srgb)
        return idx

    def lookup(self, name: str) -> Optional[int]:
        return self._names.get(name)

    def is_srgb(self, idx: int) -> bool:
        """Whether the texture was sRGB-decoded at register time (color
        maps). Display paths re-encode these through the OETF so they show
        at source brightness (the reference presents through an sRGB-aware
        swapchain; linear UNORM maps display raw)."""
        return self._srgb[idx]

    def names(self) -> list[str]:
        """Registered asset names, index-ordered (TextureDisplay's asset
        dropdown, ``ui/texturedisplay.cpp:21-80``)."""
        ordered = [""] * len(self._textures)
        for name, idx in self._names.items():
            ordered[idx] = name
        return ordered

    def get(self, idx: int) -> np.ndarray:
        """The registered texture at native resolution, (H, W, 4) f32."""
        return self._textures[idx]

    def as_atlas(self) -> tuple[np.ndarray, np.ndarray]:
        """Pack all textures into one atlas.

        Returns (atlas (A_h, A_w, 4) f32, rects (N, 4) i32 [x0, y0, w, h]).
        Shelf packing by descending height; atlas width is the smallest
        power of two >= the widest texture (min 128), height padded to a
        multiple of 8.
        """
        if not self._textures:
            atlas = np.zeros((8, 128, 4), np.float32)
            return atlas, np.asarray([[0, 0, 1, 1]], np.int32)
        order = sorted(
            range(len(self._textures)),
            key=lambda i: -self._textures[i].shape[0],
        )
        max_w = max(t.shape[1] for t in self._textures)
        width = 128
        while width < max_w:
            width *= 2
        total_area = sum(t.shape[0] * t.shape[1] for t in self._textures)
        while width * width < total_area and width < 8192:
            width *= 2

        rects = np.zeros((len(self._textures), 4), np.int64)
        shelf_y = 0
        shelf_h = 0
        cursor_x = 0
        for i in order:
            h, w = self._textures[i].shape[:2]
            if cursor_x + w > width:
                shelf_y += shelf_h
                shelf_h = 0
                cursor_x = 0
            rects[i] = (cursor_x, shelf_y, w, h)
            cursor_x += w
            shelf_h = max(shelf_h, h)
        height = _round_up8(shelf_y + shelf_h)

        ch = self._textures[0].shape[2]
        atlas = np.zeros((height, width, ch), np.float32)
        for i, tex in enumerate(self._textures):
            x0, y0, w, h = rects[i]
            atlas[y0 : y0 + h, x0 : x0 + w] = tex
        return atlas, rects.astype(np.int32)

    def as_atlas_mips(
        self, levels: int = 6
    ) -> tuple[np.ndarray, np.ndarray]:
        """Pack a full mip pyramid of every texture into one atlas.

        Beyond-parity quality feature (the reference is single-mip:
        ``assets.cpp:701-711`` allocates one level). Returns
        (atlas (A_h, A_w, 4) f32, rects (N, levels, 4) i32): row
        ``rects[i, l]`` is texture i's level-l placement; textures that
        bottom out early repeat their last level. Level l is the bilinear
        half-size reduction of level l-1 (REPEAT-safe: downsampling never
        crosses texture borders because each level is reduced
        independently before packing).
        """
        pyramids: list[list[np.ndarray]] = []
        for tex in self._textures or [np.zeros((1, 1, 4), np.float32)]:
            chain = [tex]
            for _ in range(levels - 1):
                h, w = chain[-1].shape[:2]
                if h == 1 and w == 1:
                    chain.append(chain[-1])
                else:
                    chain.append(
                        _resize_bilinear(
                            chain[-1], max(h // 2, 1), max(w // 2, 1)
                        )
                    )
            pyramids.append(chain)

        flat = [img for chain in pyramids for img in chain]
        packer = TextureLibrary(max_size=self.max_size)
        packer._textures = flat
        atlas, flat_rects = packer.as_atlas()
        rects = flat_rects.reshape(len(pyramids), levels, 4)
        return atlas, rects

    def __len__(self) -> int:
        return len(self._textures)


def quad_pack_atlas(atlas: np.ndarray, rects: np.ndarray) -> np.ndarray:
    """(A_h, A_w, 4) atlas -> (A_h, A_w, 16): each texel carries its 2x2
    bilinear footprint [t00, t10, t01, t11] with REPEAT wrapping INSIDE the
    owning rect baked in — a bilinear sample becomes ONE 64-byte gather
    (same trick as kernels.atmosphere.PackedLUT). ``rects`` may be (N, 4)
    or (N, L, 4)."""
    h, w = atlas.shape[:2]
    x1 = np.arange(w, dtype=np.int64) + 1  # default clamp; rects overwrite
    y1 = np.arange(h, dtype=np.int64) + 1
    x1[-1] = w - 1
    y1[-1] = h - 1
    xn = np.tile(x1, (h, 1))
    yn = np.tile(y1[:, None], (1, w))
    for rect in np.asarray(rects).reshape(-1, 4):
        rx, ry, rw, rh = (int(v) for v in rect)
        if rw <= 0 or rh <= 0:
            continue
        xn[ry : ry + rh, rx + rw - 1] = rx  # right edge wraps to column 0
        yn[ry + rh - 1, rx : rx + rw] = ry  # bottom edge wraps to row 0
    t00 = atlas
    t10 = atlas[np.arange(h)[:, None], xn]
    t01 = atlas[yn, np.arange(w)[None, :]]
    t11 = atlas[yn, xn]
    return np.concatenate([t00, t10, t01, t11], axis=-1)


def _upsample_repeat(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Bilinear upsample with REPEAT wrap, texel-center aligned to the
    renderer's sampling convention (``resolve._sample_atlas_rect``:
    p = u*dim - 0.5, indices mod dim): fine texel j holds the source's
    bilinear sample at u = (j + 0.5) / out_dim. Sampling the result at any
    fine texel center therefore reproduces the source sample EXACTLY; in
    between, the deviation is the source's bilinear kink inside the fine
    cell (<= max |second difference| / 8 per axis for a 2x upsample)."""
    h, w, _ = img.shape

    def coords(n_in, n_out):
        p = (np.arange(n_out, dtype=np.float64) + 0.5) * (n_in / n_out) - 0.5
        lo = np.floor(p).astype(np.int64)
        frac = (p - lo).astype(np.float32)[None, :, None]
        return lo % n_in, (lo + 1) % n_in, frac

    y0, y1, fy = coords(h, out_h)
    x0, x1, fx = coords(w, out_w)
    top = img[y0][:, x0] * (1 - fx) + img[y0][:, x1] * fx
    bot = img[y1][:, x0] * (1 - fx) + img[y1][:, x1] * fx
    fy = np.transpose(fy, (1, 0, 2))
    return (top * (1 - fy) + bot * fy).astype(np.float32)


def joint_pack_atlas(
    atlas16: np.ndarray,  # (A_h, A_w, 16) quad-packed atlas
    rects: np.ndarray,  # (N, 4) i32 per-texture rects
    materials: np.ndarray,  # (M, 3) i32 color/normal/orm texture ids
    pad: bool = False,
) -> tuple[np.ndarray, np.ndarray] | None:
    """Per-MATERIAL joint atlas: (J_h, J_w, 48), one rect per material.

    When a material's color/normal/orm textures share (w, h), their three
    bilinear samples hit the SAME within-rect texel — so the three
    quad-packed gathers can be one 48-channel gather.
    Texel values are copied from the quad-packed atlas, so the per-rect
    REPEAT wrap baked by :func:`quad_pack_atlas` is preserved and sampling
    the joint atlas is bitwise-identical to three separate samples.

    ``pad=False`` returns None unless EVERY material qualifies (the frame
    path is a static either/or; the reference's per-map descriptor sets
    have no such constraint, but its sample count is free in hardware —
    ``deferred/offscreen.frag:61-66`` samples 3 maps per fragment).
    ``pad=True`` additionally admits mixed-dimension materials by
    :func:`_upsample_repeat`-ing the smaller maps to the per-axis max dims
    and re-quad-packing them — exact at fine texel centers, approximate in
    between (measured flagship deviation RMSE 2.3e-3 / max 0.14, outside
    the parity budget — hence opt-in via ``pack_geometry``;
    tests/test_resolve.py pins the bound); same-dimension materials keep
    the bitwise slice path.
    """
    rects = np.asarray(rects)
    materials = np.asarray(materials).reshape(-1, 3)
    dims = rects[materials][..., 2:4]  # (M, 3, 2)
    if not pad and not (dims == dims[:, 0:1]).all():
        return None
    tiles = []
    for c, n, o in materials:
        joint_w = max(int(rects[t][2]) for t in (c, n, o))
        joint_h = max(int(rects[t][3]) for t in (c, n, o))
        parts = []
        for t in (c, n, o):
            rx, ry, rw, rh = (int(v) for v in rects[t])
            tile16 = atlas16[ry : ry + rh, rx : rx + rw]
            if (rw, rh) == (joint_w, joint_h):
                parts.append(tile16)
            else:
                up = _upsample_repeat(tile16[..., 0:4], joint_h, joint_w)
                parts.append(
                    quad_pack_atlas(
                        up, np.asarray([[0, 0, joint_w, joint_h]])
                    )
                )
        tiles.append(np.concatenate(parts, axis=-1))  # (joint_h, joint_w, 48)
    packer = TextureLibrary()
    packer._textures = tiles
    return packer.as_atlas()


def joint_pack_atlas_nbhd(
    atlas16: np.ndarray,  # (A_h, A_w, 16) quad-packed atlas (f32)
    rects: np.ndarray,  # (N, 4) i32 per-texture rects
    materials: np.ndarray,  # (M, 3) i32 color/normal/orm texture ids
) -> tuple[np.ndarray, np.ndarray, np.ndarray] | None:
    """EXACT mixed-dimension joint material atlas: (J_h, J_w, 108) + per-
    material rects (M, 4) at the fine (max) dims + per-role dims (M, 3, 2).

    The 48ch :func:`joint_pack_atlas` requires all three maps to share
    dims; mixed-dim materials (the chess flagship: 512/256/128 board,
    256/256/64 pieces) fall back to three separate gathers per pixel.
    This layout keeps ONE gather per pixel and stays BITWISE equal to the
    three separate samples:

    * The fine grid is the per-material per-axis max dims (W, H). For each
      role map of dims (w, h) with ratio k = W/w, the 9 channel groups of
      4 hold the 3x3 texel neighborhood at base F(ix) =
      floor((ix + 0.5)/k - 0.5) (REPEAT-wrapped): over the fine cell's
      frac range the role's own bilinear base floor(u*w - 0.5) spans an
      interval of width 1/k <= 1, so it takes only values {F, F+1} and its
      2x2 footprint lies inside {F..F+2}^2.
    * The consumer (``resolve._sample_atlas_rect_joint_nbhd``) recomputes
      each role's p = u*w - 0.5 / floor / mod with the IDENTICAL f32 ops
      as ``_sample_atlas_rect`` and selects the right 2x2 from the stored
      3x3. Consistency between the fine index and the role index is exact
      because every ratio is required to be a POWER OF TWO: f32 rounding
      commutes with scaling by 2^j, so fl(u*W) = k * fl(u*w) bit-for-bit
      and the interval argument holds on the computed values, not just in
      real arithmetic.

    Returns None when any material has a non-power-of-two or non-dividing
    dim ratio (callers then keep the separate-gather path).
    """
    rects = np.asarray(rects)
    materials = np.asarray(materials).reshape(-1, 3)
    dims = rects[materials][..., 2:4].astype(np.int32)  # (M, 3, 2)
    fine = dims.max(axis=1)  # (M, 2) per-material (W, H)
    ratios = fine[:, None, :] // np.maximum(dims, 1)
    if (dims <= 0).any():
        return None
    if (ratios * dims != fine[:, None, :]).any():
        return None  # non-dividing dims
    if (ratios & (ratios - 1)).any():
        return None  # non-power-of-two ratio

    def neighborhood(plain: np.ndarray, out_w: int, out_h: int) -> np.ndarray:
        """(h, w, 4) map -> (out_h, out_w, 36): 3x3 texels at base F."""
        h, w, _ = plain.shape
        kx, ky = out_w // w, out_h // h
        fx = np.floor((np.arange(out_w) + 0.5) / kx - 0.5).astype(np.int64)
        fy = np.floor((np.arange(out_h) + 0.5) / ky - 0.5).astype(np.int64)
        parts = []
        for dy in range(3):
            rows = (fy + dy) % h
            for dx in range(3):
                cols = (fx + dx) % w
                parts.append(plain[rows][:, cols])
        return np.concatenate(parts, axis=-1)

    tiles = []
    for m, (c, n, o) in enumerate(materials):
        out_w, out_h = (int(v) for v in fine[m])
        parts = []
        for t in (c, n, o):
            rx, ry, rw, rh = (int(v) for v in rects[t])
            plain = atlas16[ry : ry + rh, rx : rx + rw, 0:4]
            parts.append(neighborhood(plain, out_w, out_h))
        tiles.append(np.concatenate(parts, axis=-1))  # (out_h, out_w, 108)
    packer = TextureLibrary()
    packer._textures = tiles
    atlas, rects_joint = packer.as_atlas()
    return atlas, rects_joint, dims


def _round_up8(n: int) -> int:
    return (int(n) + 7) // 8 * 8


def _resize_bilinear(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Separable bilinear resize (numpy; avoids a PIL float-RGBA dependency)."""
    h, w, _ = img.shape
    if (h, w) == (out_h, out_w):
        return img

    def axis_coords(n_in, n_out):
        # align texel centers
        x = (np.arange(n_out, dtype=np.float32) + 0.5) * (n_in / n_out) - 0.5
        x = np.clip(x, 0.0, n_in - 1)
        lo = np.floor(x).astype(np.int64)
        hi = np.minimum(lo + 1, n_in - 1)
        frac = (x - lo).astype(np.float32)
        return lo, hi, frac

    ylo, yhi, yf = axis_coords(h, out_h)
    xlo, xhi, xf = axis_coords(w, out_w)
    top = img[ylo][:, xlo] * (1 - xf)[None, :, None] + img[ylo][:, xhi] * xf[None, :, None]
    bot = img[yhi][:, xlo] * (1 - xf)[None, :, None] + img[yhi][:, xhi] * xf[None, :, None]
    return (top * (1 - yf)[:, None, None] + bot * yf[:, None, None]).astype(
        np.float32
    )

"""Flagship-scene goldens: whole frame at 1e-3 RMSE + per-pass regression.

The flagship is the ABeautifulGame-class chess set (multi-material,
native-resolution textures, node-hierarchy .glb — ``assets/chess.py``),
loaded through the real glTF path. Goldens are stored u16 (quantization
noise 4.4e-6, far under the 1e-3 budget; u8 PNGs couldn't assert 1e-3).

Per-pass goldens pin the passes the whole-frame RMSE can hide:
* visibility raster: EXACT tri-id match (edge placement regression),
* lit-only frame (no atmosphere): lighting/shadow/PCF chain,
* atmosphere LUTs: the numerically hardest integrals.

Regenerate after intentional changes: python tools/regen_goldens.py
"""

import os

import numpy as np
import pytest

from syzygy_tpu.math.geometry import eulers_from_forward
from syzygy_tpu.renderer import RenderConfig, render_frame

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")
FLAGSHIP_FRAME = os.path.join(GOLDEN_DIR, "flagship_512x288.npz")
FLAGSHIP_VIS = os.path.join(GOLDEN_DIR, "flagship_vis_512x288.npz")
FLAGSHIP_LIT = os.path.join(GOLDEN_DIR, "flagship_lit_512x288.npz")
# 1920x1080 frame at parity_1080p_config(), checked on the GPU by
# chip_smoke.py (phase 3)
FLAGSHIP_1080P = os.path.join(GOLDEN_DIR, "flagship_1080p.npz")
ATMOSPHERE_LUTS = os.path.join(GOLDEN_DIR, "atmosphere_luts.npz")

W, H = 512, 288


def save_u16(path: str, img: np.ndarray) -> None:
    q = np.clip(np.round(np.asarray(img) * 65535.0), 0, 65535).astype(np.uint16)
    np.savez_compressed(path, img=q)


def load_u16(path: str) -> np.ndarray:
    return np.load(path)["img"].astype(np.float32) / 65535.0


def flagship_setup(tmp_glb=None):
    from syzygy_tpu.assets.chess import flagship_scene

    scene, lib = flagship_scene(tmp_glb)
    scene.tick(0.0)
    eye = np.array([13.0, -8.0, -14.0], np.float32)
    target = np.array([0.0, -1.0, 0.0], np.float32)
    scene.camera.position = tuple(eye)
    scene.camera.euler_angles = tuple(
        np.asarray(eulers_from_forward(target - eye))
    )
    config = RenderConfig(
        width=W, height=H, shadow_dim=512, skyview_width=256, skyview_height=128
    )
    return scene, lib, config


@pytest.fixture(scope="module")
def flagship_packed():
    from syzygy_tpu.scene import pack_frame_params, pack_geometry

    scene, lib, config = flagship_setup()
    geo = pack_geometry(scene, lib)
    params = pack_frame_params(scene, W / H)
    return geo, params, config


def test_flagship_frame_matches_golden_1e3(flagship_packed):
    geo, params, config = flagship_packed
    img = np.asarray(render_frame(geo, params, config))
    golden = load_u16(FLAGSHIP_FRAME)
    rmse = float(np.sqrt(np.mean((img - golden) ** 2)))
    assert rmse <= 1e-3, f"flagship frame RMSE {rmse:.6f} > 1e-3"


def test_flagship_visibility_ids_exact(flagship_packed):
    """Raster edge placement: the tri-id plane must match EXACTLY."""
    from syzygy_tpu.renderer.frame import _stage_geometry

    geo, params, config = flagship_packed
    _, vis, _, _ = _stage_geometry(geo, params, config)
    tri = np.asarray(vis.tri)[: config.height, : config.width]
    golden = np.load(FLAGSHIP_VIS)["tri"]
    mismatch = int((tri != golden).sum())
    assert mismatch == 0, f"{mismatch} visibility pixels changed"


def test_flagship_lit_only_matches_golden(flagship_packed):
    import dataclasses

    geo, params, config = flagship_packed
    cfg = dataclasses.replace(config, render_atmosphere=False)
    params2 = params._replace(directional_skip_count=np.int32(0))
    img = np.asarray(render_frame(geo, params2, cfg))
    golden = load_u16(FLAGSHIP_LIT)
    rmse = float(np.sqrt(np.mean((img - golden) ** 2)))
    assert rmse <= 1e-3, f"lit-only RMSE {rmse:.6f} > 1e-3"


def test_atmosphere_luts_match_golden():
    """Transmittance (500-sample) + sky-view (32-sample) integrals."""
    import jax

    from syzygy_tpu.kernels.atmosphere import (
        compute_skyview_lut,
        compute_transmittance_lut,
    )
    from syzygy_tpu.scene import pack_frame_params
    from syzygy_tpu.scene.pack import prepare_frame_state

    scene, lib, config = flagship_setup()
    params = pack_frame_params(scene, W / H)
    state = jax.jit(prepare_frame_state)(params)
    t_lut = np.asarray(compute_transmittance_lut(state.atmosphere))
    origin = np.array([0.0, 6.3601, 0.0], np.float32)
    # rowwise=False pins the quirk-exact per-texel build; the default
    # rowwise builder is covered by test_atmosphere.py::test_skyview_rowwise
    s_lut = np.asarray(
        compute_skyview_lut(
            state.atmosphere,
            origin,
            t_lut,
            width=256,
            height=128,
            rowwise=False,
        )
    )
    ref = np.load(ATMOSPHERE_LUTS)
    np.testing.assert_allclose(t_lut, ref["transmittance"], atol=2e-5)
    np.testing.assert_allclose(s_lut, ref["skyview"], atol=2e-4)

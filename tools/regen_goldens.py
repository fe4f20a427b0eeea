"""Regenerate golden frames after intentional rendering changes (on the
CPU): ``python tools/regen_goldens.py``.

``python tools/regen_goldens.py 1080p`` rewrites only the 1920x1080 chess
golden that ``chip_smoke.py`` compares the GPU frame with (a full-size CPU
render: run it on a machine with memory to spare)."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np


def main():
    only_1080p = sys.argv[1:] == ["1080p"]
    sys.path.insert(
        0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tests")
    )
    from test_golden import GOLDEN, golden_scene_setup
    from test_golden_flagship import (
        ATMOSPHERE_LUTS,
        FLAGSHIP_1080P,
        FLAGSHIP_FRAME,
        FLAGSHIP_LIT,
        FLAGSHIP_VIS,
        flagship_setup,
        save_u16,
    )

    from syzygy_tpu.renderer import render_frame
    from syzygy_tpu.scene import pack_frame_params, pack_geometry

    if not only_1080p:
        regen_small(
            GOLDEN, golden_scene_setup, ATMOSPHERE_LUTS, FLAGSHIP_FRAME,
            FLAGSHIP_LIT, FLAGSHIP_VIS, flagship_setup, save_u16,
        )

    # --- 1080p flagship (the device parity golden, chip_smoke.py) -----------
    from syzygy_tpu.app.scenes import framed_scene, parity_1080p_config

    config = parity_1080p_config()
    scene, lib = framed_scene("flagship")
    img = np.asarray(
        render_frame(
            pack_geometry(scene, lib),
            pack_frame_params(scene, config.width / config.height),
            config,
        )
    )
    save_u16(FLAGSHIP_1080P, img)
    print(f"wrote {FLAGSHIP_1080P} (mean {img.mean():.4f})", flush=True)


def regen_small(
    GOLDEN, golden_scene_setup, ATMOSPHERE_LUTS, FLAGSHIP_FRAME, FLAGSHIP_LIT,
    FLAGSHIP_VIS, flagship_setup, save_u16,
):
    import dataclasses

    from syzygy_tpu.renderer import render_frame
    from syzygy_tpu.renderer.frame import _stage_geometry
    from syzygy_tpu.scene import pack_frame_params, pack_geometry
    from syzygy_tpu.utils import write_png

    scene, lib, config = golden_scene_setup()
    geo = pack_geometry(scene, lib)
    img = np.asarray(
        render_frame(
            geo, pack_frame_params(scene, config.width / config.height), config
        )
    )
    write_png(GOLDEN, img)
    print(f"wrote {GOLDEN} (mean {img.mean():.4f})", flush=True)

    # --- flagship chess scene -------------------------------------------
    scene, lib, config = flagship_setup()
    geo = pack_geometry(scene, lib)
    params = pack_frame_params(scene, config.width / config.height)

    img = np.asarray(render_frame(geo, params, config))
    save_u16(FLAGSHIP_FRAME, img)
    print(f"wrote {FLAGSHIP_FRAME} (mean {img.mean():.4f})", flush=True)

    _, vis, _, _ = _stage_geometry(geo, params, config)
    tri = np.asarray(vis.tri)[: config.height, : config.width]
    np.savez_compressed(FLAGSHIP_VIS, tri=tri)
    print(f"wrote {FLAGSHIP_VIS} ({int((tri >= 0).sum())} covered px)", flush=True)

    cfg_lit = dataclasses.replace(config, render_atmosphere=False)
    params2 = params._replace(directional_skip_count=np.int32(0))
    lit = np.asarray(render_frame(geo, params2, cfg_lit))
    save_u16(FLAGSHIP_LIT, lit)
    print(f"wrote {FLAGSHIP_LIT} (mean {lit.mean():.4f})", flush=True)

    # --- atmosphere LUTs ----------------------------------------------------
    from syzygy_tpu.kernels.atmosphere import (
        compute_skyview_lut,
        compute_transmittance_lut,
    )
    from syzygy_tpu.scene.pack import prepare_frame_state

    state = jax.jit(prepare_frame_state)(params)
    t_lut = np.asarray(compute_transmittance_lut(state.atmosphere))
    origin = np.array([0.0, 6.3601, 0.0], np.float32)
    # rowwise=False: the golden pins the quirk-exact per-texel build
    # (test_atmosphere_luts_match_golden asserts with rowwise=False)
    s_lut = np.asarray(
        compute_skyview_lut(
            state.atmosphere, origin, t_lut, width=256, height=128,
            rowwise=False,
        )
    )
    np.savez_compressed(ATMOSPHERE_LUTS, transmittance=t_lut, skyview=s_lut)
    print(f"wrote {ATMOSPHERE_LUTS}", flush=True)


if __name__ == "__main__":
    main()

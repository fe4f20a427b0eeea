"""Whole-frame integration: staged path, sharded path, driver entry points."""

import jax
import numpy as np
import pytest

from syzygy_tpu.math.geometry import eulers_from_forward
from syzygy_tpu.renderer import RenderConfig, render_frame
from syzygy_tpu.scene import default_scene, pack_frame_params, pack_geometry

W, H = 256, 128


@pytest.fixture(scope="module")
def frame_setup():
    scene, library = default_scene()
    scene.sun_animation.time = 0.35
    scene.sun_animation.frozen = True
    scene.tick(0.0)
    eye = np.array([18.0, -16.0, -22.0], np.float32)
    target = np.array([0.0, -6.0, 0.0], np.float32)
    scene.camera.position = tuple(eye)
    scene.camera.euler_angles = tuple(
        np.asarray(eulers_from_forward(target - eye))
    )
    config = RenderConfig(
        width=W,
        height=H,
        shadow_dim=256,
        skyview_width=128,
        skyview_height=64,
    )
    geometry = pack_geometry(scene, library)
    params = pack_frame_params(scene, W / H)
    return scene, geometry, params, config


def test_full_frame_structure(frame_setup):
    _, geometry, params, config = frame_setup
    img = np.asarray(render_frame(geometry, params, config))
    assert img.shape == (H, W, 3)
    assert np.isfinite(img).all()
    assert (img >= 0).all() and (img <= 1).all()
    # morning sky: top rows are sky (blue channel dominates red)
    sky = img[:12]
    assert sky[..., 2].mean() > sky[..., 0].mean()
    # scene is day-lit: meaningful average brightness
    assert img.mean() > 0.2
    # geometry occupies the middle (dark cubes vs bright floor: variance)
    assert img.std() > 0.1


def test_no_atmosphere_path(frame_setup):
    _, geometry, params, config = frame_setup
    import dataclasses

    cfg = dataclasses.replace(config, render_atmosphere=False)
    params2 = params._replace(directional_skip_count=np.int32(0))
    img = np.asarray(render_frame(geometry, params2, cfg))
    # background (sky region) stays black without the sky pass
    assert img[0, :8].max() == 0.0
    # geometry is still directly lit by the sun (skip count 0)
    assert img.max() > 0.05


def test_debug_lines_overlay(frame_setup):
    _, geometry, params, config = frame_setup
    import dataclasses

    cfg = dataclasses.replace(config, debug_lines=True)
    scene, *_ = frame_setup
    dbg_params = pack_frame_params(scene, W / H, debug_lines=True)
    img = np.asarray(render_frame(geometry, dbg_params, cfg))
    params = dbg_params
    base = np.asarray(render_frame(geometry, params, config))
    diff = img != base
    assert diff.any()  # lines drew something
    # drawn pixels are pure green pre-OETF -> max green post-OETF
    changed = np.argwhere(diff.any(axis=-1))
    ys, xs = changed[:, 0], changed[:, 1]
    assert (img[ys, xs, 1] > 0.99).all()


def test_sharded_matches_single_chip(frame_setup):
    _, geometry, params, config = frame_setup
    from syzygy_tpu.parallel import (
        batch_params,
        make_mesh,
        render_frames_sharded,
        replicate_to_mesh,
    )

    if len(jax.devices()) < 4:
        pytest.skip("needs 4 virtual devices")
    mesh = make_mesh(dp=2, sp=2)
    batch = batch_params([params, params])
    geo_r = replicate_to_mesh(geometry, mesh)
    out = np.asarray(render_frames_sharded(geo_r, batch, config, mesh))
    single = np.asarray(render_frame(geometry, params, config))
    assert out.shape == (2, H, W, 3)
    # The RASTER is bitwise under sharding (global-coordinate kernels —
    # the origin add is an exact f32 integer add), so the only remaining
    # drift is the sky row-chunk program-shape fma class (<= ~2e-5);
    # identical frames
    # must also match each other exactly.
    np.testing.assert_allclose(out[0], single, atol=1e-4)
    np.testing.assert_array_equal(out[0], out[1])


def test_sharded_nondivisible_height_matches_single_chip(frame_setup):
    """A padded height that sp does not divide: the sharded path pads rows
    to sp*TILE_H and crops. Shard a frame whose padded height is not a
    multiple of 4 tile rows over sp=4 (one device renders ONLY junk
    off-screen rows) and check the crop against the single-chip frame."""
    scene, geometry, _, config = frame_setup
    import dataclasses

    from syzygy_tpu.parallel import (
        batch_params,
        make_mesh,
        render_frames_sharded,
        replicate_to_mesh,
    )
    from syzygy_tpu.scene import pack_frame_params

    if len(jax.devices()) < 4:
        pytest.skip("needs 4 virtual devices")
    cfg = dataclasses.replace(config, width=192, height=136)  # pads to 192
    params = pack_frame_params(scene, cfg.width / cfg.height)
    mesh = make_mesh(dp=1, sp=4)
    batch = batch_params([params])
    geo_r = replicate_to_mesh(geometry, mesh)
    out = np.asarray(render_frames_sharded(geo_r, batch, cfg, mesh))
    single = np.asarray(render_frame(geometry, params, cfg))
    assert out.shape == (1, 136, 192, 3)
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out[0], single, atol=1e-4)


def test_sharded_vma_checked(frame_setup):
    """shard_map(check_vma=True) traces the production 1080p shape end to
    end: raster pallas outs carry vma, loop carries are match_vma'd, and
    the raster kernel runs with the vma check on. A spec/vma error anywhere
    in the frame graph fails HERE, at trace time, instead of at runtime on
    devices.

    Uses the ONE-program formulation: the production split path's stage
    boundary declares state/records/shadow maps sp-replicated, which is
    true (they derive from replicated params or all_gathers) but not
    provable to the vma checker (all_gather outputs stay sp-varying to
    it) — the per-device math being checked is identical either way."""
    scene, geometry, _, _ = frame_setup
    import syzygy_tpu.parallel.sharding as sharding_mod
    from syzygy_tpu.parallel import batch_params, make_mesh, render_frames_sharded
    from syzygy_tpu.scene import pack_frame_params

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    config = RenderConfig(width=1920, height=1080, n_shadow_maps=4)
    params = pack_frame_params(scene, 1920 / 1080)
    old_split = sharding_mod.SHARDED_SPLIT_PROGRAMS
    sharding_mod.SHARDED_SPLIT_PROGRAMS = False
    try:
        for dp, sp in [(1, 2), (1, 8), (2, 4)]:
            mesh = make_mesh(dp=dp, sp=sp)
            batch = batch_params([params] * dp)
            out = jax.eval_shape(
                lambda g, b: render_frames_sharded(g, b, config, mesh),
                geometry,
                batch,
            )
            assert out.shape == (dp, 1080, 1920, 3), (dp, sp, out.shape)
    finally:
        sharding_mod.SHARDED_SPLIT_PROGRAMS = old_split


def test_sharded_1080p_spec_traces(frame_setup):
    """Trace-time shape check: render_frames_sharded must ACCEPT the
    production 1920x1080 shape at every sp (r3 it raised ValueError for
    all of them) and produce the right output spec — abstract eval only,
    no CPU render of a 2-Mpx frame."""
    scene, geometry, _, _ = frame_setup
    from syzygy_tpu.parallel import batch_params, make_mesh, render_frames_sharded
    from syzygy_tpu.scene import pack_frame_params

    n = len(jax.devices())
    if n < 8:
        pytest.skip("needs 8 virtual devices")
    config = RenderConfig(width=1920, height=1080, n_shadow_maps=4)
    params = pack_frame_params(scene, 1920 / 1080)
    for dp, sp in [(1, 2), (1, 4), (1, 8), (2, 4)]:
        mesh = make_mesh(dp=dp, sp=sp)
        batch = batch_params([params] * dp)
        out = jax.eval_shape(
            lambda g, b: render_frames_sharded(g, b, config, mesh),
            geometry,
            batch,
        )
        assert out.shape == (dp, 1080, 1920, 3), (dp, sp, out.shape)


def test_graft_entry_contract():
    import __graft_entry__ as ge

    fn, args = ge.entry()
    out = jax.jit(fn)(*args)
    assert out.ndim == 3 and out.shape[-1] == 3
    assert bool(jax.numpy.isfinite(out).all())


def test_light_parallel_shadow_maps_match_serial(frame_setup):
    """The sp-partitioned shadow pass (lights sharded over the mesh axis,
    rejoined via all_gather) must produce bit-identical maps to the serial
    lax.map path."""
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from syzygy_tpu.parallel import make_mesh
    from syzygy_tpu.renderer.frame import _shadow_pass
    from syzygy_tpu.scene.pack import prepare_frame_state

    if len(jax.devices()) < 4:
        pytest.skip("needs 4 virtual devices")
    _, geometry, params, config = frame_setup
    state = prepare_frame_state(params)
    from syzygy_tpu.kernels.resolve import transform_positions

    proj_view = state.camera.projection @ state.camera.view
    _, world = transform_positions(
        geometry.positions, geometry.vert_instance, state.models, proj_view
    )
    world_h = jnp.concatenate(
        [world, jnp.ones((world.shape[0], 1), jnp.float32)], axis=-1
    )

    serial = np.asarray(_shadow_pass(geometry, world_h, state, config))

    mesh = make_mesh(dp=1, sp=4)
    fn = jax.shard_map(
        lambda g, w, s: _shadow_pass(g, w, s, config, shard_axis="sp"),
        mesh=mesh,
        in_specs=(P(), P(), P()),
        out_specs=P(),
        check_vma=False,
    )
    sharded = np.asarray(fn(geometry, world_h, state))
    np.testing.assert_array_equal(serial, sharded)


def test_sharded_supersampling_matches_staged(frame_setup):
    """SSAA through the sharded row path must match the staged path
    (regression: render_frame_rows once used width/height instead of
    render_width/render_height for triangle setup)."""
    import dataclasses

    from syzygy_tpu.parallel import (
        batch_params,
        make_mesh,
        render_frames_sharded,
        replicate_to_mesh,
    )

    if len(jax.devices()) < 2:
        pytest.skip("needs 2 virtual devices")
    _, geometry, params, config = frame_setup
    cfg = dataclasses.replace(config, supersample=2)
    mesh = make_mesh(dp=1, sp=2)
    batch = batch_params([params])
    geo_r = replicate_to_mesh(geometry, mesh)
    out = np.asarray(render_frames_sharded(geo_r, batch, cfg, mesh))
    single = np.asarray(render_frame(geometry, params, cfg))
    assert out.shape == (1, H, W, 3)
    np.testing.assert_allclose(out[0], single, atol=1e-2)
    assert np.abs(out[0] - single).mean() < 2e-3


def test_sky_row_chunks_equivalent(frame_setup):
    """The chunked sky camera pass (platform-compiler workaround at 1080p)
    computes the same per-pixel math as the unchunked one. The two compile
    as different program shapes, so XLA's fusion/reassociation choices may
    differ at float-noise level (observed up to ~2e-5; the parity budget
    is 1e-3) — in both the quirk-exact and aerial-LUT paths."""
    import dataclasses

    _, geometry, params, config = frame_setup
    for cfg in (
        dataclasses.replace(config, aerial_lut=False),
        config,
    ):
        base = np.asarray(render_frame(geometry, params, cfg))
        chunked = np.asarray(
            render_frame(
                geometry, params, dataclasses.replace(cfg, sky_row_chunks=4)
            )
        )
        np.testing.assert_allclose(base, chunked, atol=1e-4)


def test_supersampling_shape_and_smoothing(frame_setup):
    import dataclasses

    _, geometry, params, config = frame_setup
    cfg2 = dataclasses.replace(config, supersample=2)
    img1 = np.asarray(render_frame(geometry, params, config))
    img2 = np.asarray(render_frame(geometry, params, cfg2))
    assert img2.shape == img1.shape
    # SSAA softens the hardest edge
    g1 = np.abs(np.diff(img1.mean(-1), axis=1)).max()
    g2 = np.abs(np.diff(img2.mean(-1), axis=1)).max()
    assert g2 <= g1 + 1e-6


def test_fused_lighting_sky_matches_staged(frame_setup):
    """fuse_lighting_sky=True merges two device programs; math unchanged —
    results differ only at XLA fusion/reassociation noise."""
    import dataclasses

    _, geometry, params, config = frame_setup
    base = np.asarray(render_frame(geometry, params, config))
    fused = np.asarray(
        render_frame(
            geometry, params,
            dataclasses.replace(config, fuse_lighting_sky=True),
        )
    )
    assert np.abs(fused - base).max() <= 2e-5


def test_sky_chunks_refuses_oversized_configs():
    """_sky_chunks refuses an explicit row-chunk count that does not divide
    the padded height, and auto always divides it."""
    from syzygy_tpu.renderer.frame import _sky_chunks

    assert _sky_chunks(128, 0) == 1  # small: single chunk
    for h in (128, 1088, 2176):
        n = _sky_chunks(h, 0)
        assert n >= 1 and h % n == 0
    assert _sky_chunks(1088, 2) == 2  # a dividing override holds
    assert _sky_chunks(1088, 16) == 16
    # explicit override that does not divide -> refuse
    with pytest.raises(ValueError):
        _sky_chunks(1088, 3)
    with pytest.raises(ValueError):
        _sky_chunks(1088, 5)


def test_joint_material_atlas_bitwise(frame_setup):
    """Joint 48ch material atlas (one gather for color+normal+orm) is
    bitwise-identical to the 3-gather path on the default scene (every
    material's three maps share dimensions, so it qualifies)."""
    scene, geometry, params, config = frame_setup
    assert geometry.tex_atlas_joint is not None, (
        "default scene should qualify for joint material packing"
    )
    assert geometry.tex_atlas_joint.shape[-1] == 48
    _, library = default_scene()
    geo_sep = pack_geometry(scene, library, joint_pack=False)
    assert geo_sep.tex_atlas_joint is None
    a = np.asarray(render_frame(geometry, params, config))
    b = np.asarray(render_frame(geo_sep, params, config))
    np.testing.assert_array_equal(a, b)


def test_joint_material_atlas_disqualifies_mixed_dims():
    """Materials whose maps differ in size must NOT joint-pack (the
    flagship's 512/256/64 materials take the 3-gather path)."""
    from syzygy_tpu.assets.types import TextureLibrary, joint_pack_atlas, quad_pack_atlas

    lib = TextureLibrary()
    lib.register("c", np.ones((64, 64, 4), np.float32))
    lib.register("n", np.ones((32, 32, 4), np.float32))
    lib.register("o", np.ones((64, 64, 4), np.float32))
    atlas, rects = lib.as_atlas()
    atlas16 = quad_pack_atlas(atlas, rects)
    mats = np.array([[0, 1, 2]], np.int32)
    assert joint_pack_atlas(atlas16, rects, mats) is None
    mats_ok = np.array([[0, 2, 2]], np.int32)
    joint = joint_pack_atlas(atlas16, rects, mats_ok)
    assert joint is not None and joint[0].shape[-1] == 48


def test_fuse_lighting_sky_chunks_matches():
    """fuse_lighting_sky_chunks moves the (purely per-pixel) lighting pass
    inside the sky pass's row-chunk lax.map; frames must match the
    separate-phase pipeline to XLA reassociation noise (the sky row-chunk
    precedent, <= ~2e-5)."""
    import dataclasses

    import numpy as np

    from syzygy_tpu.math.geometry import eulers_from_forward
    from syzygy_tpu.renderer import RenderConfig, render_frame
    from syzygy_tpu.scene import default_scene, pack_frame_params, pack_geometry

    scene, lib = default_scene()
    scene.sun_animation.time = 0.35
    scene.tick(0.0)
    eye = np.array([18.0, -16.0, -22.0], np.float32)
    target = np.array([0.0, -6.0, 0.0], np.float32)
    scene.camera.position = tuple(eye)
    scene.camera.euler_angles = tuple(
        np.asarray(eulers_from_forward(target - eye))
    )
    config = RenderConfig(
        width=128, height=64, shadow_dim=128, skyview_width=128,
        skyview_height=64, sky_row_chunks=2,
    )
    geo = pack_geometry(scene, lib)
    params = pack_frame_params(scene, 2.0)
    a = np.asarray(render_frame(geo, params, config))
    b = np.asarray(
        render_frame(
            geo,
            params,
            dataclasses.replace(config, fuse_lighting_sky_chunks=True),
        )
    )
    d = np.abs(a - b)
    assert d.max() <= 2e-5, (d.max(), (d > 0).mean())


def test_resolve_in_sky_chunks_matches():
    """resolve_in_sky_chunks defers the (purely per-pixel, single-mip)
    G-buffer resolve into the lighting+sky program's row chunks; frames
    must match the phase-separated pipeline to XLA reassociation noise."""
    import dataclasses

    import numpy as np

    from syzygy_tpu.math.geometry import eulers_from_forward
    from syzygy_tpu.renderer import RenderConfig, render_frame
    from syzygy_tpu.scene import default_scene, pack_frame_params, pack_geometry

    scene, lib = default_scene()
    scene.sun_animation.time = 0.35
    scene.tick(0.0)
    eye = np.array([18.0, -16.0, -22.0], np.float32)
    target = np.array([0.0, -6.0, 0.0], np.float32)
    scene.camera.position = tuple(eye)
    scene.camera.euler_angles = tuple(
        np.asarray(eulers_from_forward(target - eye))
    )
    config = RenderConfig(
        width=128, height=64, shadow_dim=128, skyview_width=128,
        skyview_height=64, sky_row_chunks=2,
    )
    geo = pack_geometry(scene, lib)
    params = pack_frame_params(scene, 2.0)
    a = np.asarray(render_frame(geo, params, config))
    b = np.asarray(
        render_frame(
            geo,
            params,
            dataclasses.replace(
                config,
                fuse_lighting_sky_chunks=True,
                resolve_in_sky_chunks=True,
            ),
        )
    )
    d = np.abs(a - b)
    assert d.max() <= 2e-5, (d.max(), (d > 0).mean())


def test_sharded_non_records_configs_match_single_chip(frame_setup):
    """The split sharded path's OTHER stage boundary: when the resolve
    cannot defer (no atmosphere, or mipmapped geometry), the row-sharded
    G-BUFFER crosses the program boundary instead of the replicated
    records table — both configurations must match the staged path."""
    import dataclasses

    scene, geometry, params, config = frame_setup
    from syzygy_tpu.parallel import (
        batch_params,
        make_mesh,
        render_frames_sharded,
        replicate_to_mesh,
    )
    from syzygy_tpu.scene import default_scene as _ds

    if len(jax.devices()) < 2:
        pytest.skip("needs 2 virtual devices")
    mesh = make_mesh(dp=1, sp=2)

    # no-atmosphere: lit-only output
    cfg = dataclasses.replace(config, render_atmosphere=False)
    params2 = params._replace(directional_skip_count=np.int32(0))
    out = np.asarray(
        render_frames_sharded(
            replicate_to_mesh(geometry, mesh),
            batch_params([params2]), cfg, mesh,
        )
    )
    single = np.asarray(render_frame(geometry, params2, cfg))
    assert out.shape == (1, H, W, 3)
    # no atmosphere = no row-chunked sky program: the whole sharded frame
    # is BITWISE equal to single-chip (raster exact via global coords;
    # lighting is elementwise over identical inputs)
    np.testing.assert_array_equal(out[0], single)

    # mipmapped geometry: the mip resolve's cross-pixel LOD derivatives
    # keep the resolve in the geometry stage (records never built)
    scene2, library2 = _ds()
    geo_mips = pack_geometry(scene2, library2, mipmaps=True)
    assert geo_mips.tex_rects_mips is not None
    out = np.asarray(
        render_frames_sharded(
            replicate_to_mesh(geo_mips, mesh),
            batch_params([params]), config, mesh,
        )
    )
    single = np.asarray(render_frame(geo_mips, params, config))
    np.testing.assert_allclose(out[0], single, atol=1e-2)

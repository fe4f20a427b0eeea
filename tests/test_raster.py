"""Visibility rasterizer vs a brute-force numpy reference."""

import numpy as np
import pytest

from syzygy_tpu.kernels import rasterize, setup_triangles

W, H = 256, 128


def np_reference_raster(tris, width, height):
    """tris: (N, 3, 3) screen-space (x, y, z). Same conventions as the kernel:
    pixel centers +0.5, bary inside test, reverse-Z z >= current, later tri
    wins ties. No culling."""
    depth = np.zeros((height, width), np.float32)
    tri_id = np.full((height, width), -1, np.int32)
    ys, xs = np.mgrid[0:height, 0:width]
    px = xs + 0.5
    py = ys + 0.5
    for t, tri in enumerate(tris):
        (x0, y0, z0), (x1, y1, z1), (x2, y2, z2) = tri
        area2 = (x1 - x0) * (y2 - y0) - (y1 - y0) * (x2 - x0)
        if abs(area2) < 1e-12:
            continue
        inv = 1.0 / area2
        b0 = (-(y2 - y1) * px + (x2 - x1) * py + ((y2 - y1) * x1 - (x2 - x1) * y1)) * inv
        b1 = (-(y0 - y2) * px + (x0 - x2) * py + ((y0 - y2) * x2 - (x0 - x2) * y2)) * inv
        b2 = 1.0 - b0 - b1
        z = b0 * z0 + b1 * z1 + b2 * z2
        hit = (b0 >= 0) & (b1 >= 0) & (b2 >= 0) & (z >= depth) & (z <= 1) & (z >= 0)
        depth = np.where(hit, z, depth)
        tri_id = np.where(hit, t, tri_id)
    return depth, tri_id


def min_edge_distance(tris, tri_ids, ys, xs):
    """For each pixel, min |bary| over all triangles' edges (f64) — how close
    the pixel center is to a coverage boundary."""
    out = np.full(len(ys), np.inf)
    px, py = xs + 0.5, ys + 0.5
    for tri in np.asarray(tris, np.float64):
        (x0, y0, _), (x1, y1, _), (x2, y2, _) = tri
        area2 = (x1 - x0) * (y2 - y0) - (y1 - y0) * (x2 - x0)
        if abs(area2) < 1e-12:
            continue
        inv = 1.0 / area2
        b0 = (-(y2 - y1) * px + (x2 - x1) * py + ((y2 - y1) * x1 - (x2 - x1) * y1)) * inv
        b1 = (-(y0 - y2) * px + (x0 - x2) * py + ((y0 - y2) * x2 - (x0 - x2) * y2)) * inv
        b2 = 1.0 - b0 - b1
        out = np.minimum(out, np.min(np.abs([b0, b1, b2]), axis=0))
    return out


def assert_raster_matches(vis, tris, ref_depth, ref_tri, edge_tol=1e-4):
    """Exact match away from edges; pixels within edge_tol of a coverage
    boundary may flip (f32 kernel vs f64 reference rounding)."""
    kt = np.asarray(vis.tri)
    diff = kt != ref_tri
    if diff.any():
        ys, xs = np.nonzero(diff)
        dist = min_edge_distance(tris, ref_tri, ys, xs)
        assert (dist < edge_tol).all(), (
            f"{diff.sum()} mismatches, worst edge distance {dist.max()}"
        )
    same = ~diff
    np.testing.assert_allclose(
        np.asarray(vis.depth)[same], ref_depth[same], atol=1e-5
    )


def screen_to_clip(tris_screen, width, height):
    """Inverse of the kernel's viewport transform with w=1 (no perspective)."""
    s = np.asarray(tris_screen, np.float32)
    ndc_x = s[..., 0] / width * 2.0 - 1.0
    ndc_y = s[..., 1] / height * 2.0 - 1.0
    clip = np.stack(
        [ndc_x, ndc_y, s[..., 2], np.ones_like(ndc_x)], axis=-1
    )
    return clip.reshape(-1, 4)


def run_kernel(tris_screen, cull=0):
    clip = screen_to_clip(tris_screen, W, H)
    n = len(tris_screen)
    triangles = np.arange(n * 3, dtype=np.int32).reshape(n, 3)
    setup = setup_triangles(
        clip, triangles, np.ones(n, bool), W, H, cull_keep_sign=cull
    )
    return rasterize(setup, W, H)


def test_single_triangle_coverage_and_depth():
    tris = [[[40.0, 20.0, 0.5], [200.0, 30.0, 0.5], [100.0, 110.0, 0.5]]]
    vis = run_kernel(tris)
    ref_depth, ref_tri = np_reference_raster(np.asarray(tris), W, H)
    assert_raster_matches(vis, tris, ref_depth, ref_tri)
    assert (ref_tri == 0).sum() > 1000  # sanity: it actually drew something


def test_two_triangles_depth_order():
    # Second triangle is nearer (reverse-Z: larger depth) over the overlap
    tris = [
        [[10.0, 10.0, 0.3], [240.0, 10.0, 0.3], [120.0, 120.0, 0.3]],
        [[60.0, 5.0, 0.7], [180.0, 5.0, 0.7], [120.0, 90.0, 0.7]],
    ]
    vis = run_kernel(tris)
    ref_depth, ref_tri = np_reference_raster(np.asarray(tris), W, H)
    assert_raster_matches(vis, tris, ref_depth, ref_tri)
    assert (np.asarray(vis.tri) == 1).any()
    assert (np.asarray(vis.tri) == 0).any()


def test_equal_depth_later_wins():
    tris = [
        [[10.0, 10.0, 0.5], [240.0, 10.0, 0.5], [120.0, 120.0, 0.5]],
        [[10.0, 10.0, 0.5], [240.0, 10.0, 0.5], [120.0, 120.0, 0.5]],
    ]
    vis = run_kernel(tris)
    covered = np.asarray(vis.tri)[np.asarray(vis.tri) >= 0]
    assert (covered == 1).all()  # GREATER_OR_EQUAL: later triangle wins ties


def test_backface_cull_sign():
    # CW on screen (y down) has positive doubled area -> front for gbuffer
    cw = [[[40.0, 20.0, 0.5], [200.0, 30.0, 0.5], [100.0, 110.0, 0.5]]]
    ccw = [[t[0], t[2], t[1]] for t in cw]
    assert (np.asarray(run_kernel(cw, cull=+1).tri) >= 0).any()
    assert not (np.asarray(run_kernel(ccw, cull=+1).tri) >= 0).any()
    # shadow pass keeps the other side
    assert not (np.asarray(run_kernel(cw, cull=-1).tri) >= 0).any()
    assert (np.asarray(run_kernel(ccw, cull=-1).tri) >= 0).any()


def test_bary_reconstructs_position():
    tris = [[[40.0, 20.0, 0.2], [200.0, 30.0, 0.9], [100.0, 110.0, 0.5]]]
    vis = run_kernel(tris)
    tri_np = np.asarray(tris, np.float32)[0]
    mask = np.asarray(vis.tri) == 0
    b0 = np.asarray(vis.b0)[mask]
    b1 = np.asarray(vis.b1)[mask]
    b2 = 1.0 - b0 - b1
    # interpolated x,y must land back on the pixel centers
    ys, xs = np.nonzero(mask)
    ix = b0 * tri_np[0, 0] + b1 * tri_np[1, 0] + b2 * tri_np[2, 0]
    iy = b0 * tri_np[0, 1] + b1 * tri_np[1, 1] + b2 * tri_np[2, 1]
    np.testing.assert_allclose(ix, xs + 0.5, atol=2e-2)
    np.testing.assert_allclose(iy, ys + 0.5, atol=2e-2)


def test_near_clip_no_nans_and_partial_coverage():
    # triangle crossing the w=0 plane: one vertex behind the camera
    clip = np.array(
        [
            [-0.5, -0.5, 0.5, 1.0],
            [0.5, -0.5, 0.5, 1.0],
            [0.0, 0.5, -0.5, -0.5],  # behind
        ],
        np.float32,
    )
    setup = setup_triangles(
        clip, np.array([[0, 1, 2]], np.int32), np.ones(1, bool), W, H, 0
    )
    vis = rasterize(setup, W, H)
    assert np.isfinite(np.asarray(vis.depth)).all()
    assert (np.asarray(vis.tri) >= 0).any()  # front part still drawn


def test_fully_behind_culled():
    clip = np.array(
        [[0.0, 0.0, 0.5, -1.0], [0.5, 0.0, 0.5, -1.0], [0.0, 0.5, 0.5, -2.0]],
        np.float32,
    )
    setup = setup_triangles(
        clip, np.array([[0, 1, 2]], np.int32), np.ones(1, bool), W, H, 0
    )
    vis = rasterize(setup, W, H)
    assert not (np.asarray(vis.tri) >= 0).any()


def test_depth_only_variant():
    tris = [[[40.0, 20.0, 0.5], [200.0, 30.0, 0.5], [100.0, 110.0, 0.5]]]
    clip = screen_to_clip(tris, W, H)
    setup = setup_triangles(
        clip, np.array([[0, 1, 2]], np.int32), np.ones(1, bool), W, H, 0
    )
    vis = rasterize(setup, W, H, depth_only=True)
    ref_depth, _ = np_reference_raster(np.asarray(tris), W, H)
    close = np.isclose(np.asarray(vis.depth), ref_depth, atol=1e-5)
    ys, xs = np.nonzero(~close)
    if len(ys):
        assert (min_edge_distance(tris, None, ys, xs) < 1e-4).all()


def test_many_triangles_multi_chunk():
    # >64 triangles forces multiple chunks; strips across the image
    rng = np.random.default_rng(7)
    n = 150
    tris = []
    for i in range(n):
        cx, cy = rng.uniform(10, W - 10), rng.uniform(10, H - 10)
        pts = rng.uniform(-12, 12, (3, 2)) + [cx, cy]
        z = rng.uniform(0.1, 0.9)
        tris.append([[p[0], p[1], z] for p in pts])
    vis = run_kernel(tris)
    ref_depth, ref_tri = np_reference_raster(np.asarray(tris), W, H)
    assert_raster_matches(vis, tris, ref_depth, ref_tri)


def random_tris(seed, n, spread, width=W, height=H, margin=10):
    rng = np.random.default_rng(seed)
    tris = []
    for _ in range(n):
        cx = rng.uniform(margin, width - margin)
        cy = rng.uniform(margin, height - margin)
        pts = rng.uniform(-spread, spread, (3, 2)) + [cx, cy]
        z = rng.uniform(0.05, 0.95)
        tris.append([[p[0], p[1], z] for p in pts])
    return tris


def setup_of(tris, width=W, height=H, cull=0):
    clip = screen_to_clip(tris, width, height)
    n = len(tris)
    triangles = np.arange(n * 3, dtype=np.int32).reshape(n, 3)
    return setup_triangles(
        clip, triangles, np.ones(n, bool), width, height, cull_keep_sign=cull
    )


def assert_same_visibility(a, b, bary_atol=0.0):
    np.testing.assert_array_equal(np.asarray(a.tri), np.asarray(b.tri))
    np.testing.assert_array_equal(np.asarray(a.depth), np.asarray(b.depth))
    for field in ("b0", "b1"):
        np.testing.assert_allclose(
            np.asarray(getattr(a, field)),
            np.asarray(getattr(b, field)),
            atol=bary_atol,
            rtol=0,
            err_msg=field,
        )


def test_listed_raster_matches_baseline():
    """The kernel (Pallas interpreter on CPU) against the plain-XLA
    formulation of the same contract, rasterize_xla: identical visibility
    decisions; barycentrics within fma-contraction noise."""
    from syzygy_tpu.kernels.raster import rasterize_xla

    tris = random_tris(11, 200, 15)
    for dst, src in [(50, 3), (120, 10)]:  # exact duplicates: depth ties
        tris[dst] = tris[src]
    setup = setup_of(tris)
    assert_same_visibility(
        rasterize(setup, W, H), rasterize_xla(setup, W, H), bary_atol=2e-5
    )
    np.testing.assert_array_equal(
        np.asarray(rasterize(setup, W, H, depth_only=True).depth),
        np.asarray(rasterize_xla(setup, W, H, depth_only=True).depth),
    )


def test_listed_raster_reports_overflow():
    """A tile crowded with far more chunks than any fixed per-tile list
    capacity loses nothing: 500 overlapping triangles in one tile (1,000
    slots over many chunks), each nearer than the one before, match the
    numpy reference, so the last one is visible."""
    tris = [
        [[10.0 + i * 0.01, 10.0, z], [30.0, 12.0, z], [20.0, 28.0, z]]
        for i, z in enumerate(np.linspace(0.1, 0.9, 500))
    ]
    setup = setup_of(tris)
    vis = rasterize(setup, W, H)
    ref_depth, ref_tri = np_reference_raster(np.asarray(tris), W, H)
    assert_raster_matches(vis, tris, ref_depth, ref_tri)
    assert np.asarray(vis.tri).max() == 499


def test_dispatch_raster_lossless_on_overflow():
    """The frame's raster call (global origin operand, padded grid) never
    drops geometry: a crowded block rastered at a row origin equals the
    same rows of the whole-target raster."""
    rng = np.random.default_rng(3)
    n = 500
    tris = []
    for _ in range(n):
        cx, cy = rng.uniform(10, 100), rng.uniform(40, 90)
        pts = rng.uniform(-8, 8, (3, 2)) + [cx, cy]
        z = rng.uniform(0.1, 0.9)
        tris.append([[p[0], p[1], z] for p in pts])
    setup = setup_of(tris)
    full = rasterize(setup, W, H)
    ref_depth, ref_tri = np_reference_raster(np.asarray(tris), W, H)
    assert_raster_matches(full, tris, ref_depth, ref_tri)
    row0 = 32
    block = rasterize(setup, W, 64, origin=np.array([row0, 0], np.int32))
    for field in ("depth", "tri", "b0", "b1"):
        np.testing.assert_array_equal(
            np.asarray(getattr(block, field)),
            np.asarray(getattr(full, field))[row0:row0 + 64],
            err_msg=field,
        )


@pytest.mark.parametrize("seed", [13, 17])
def test_vector_chunk_equivalence(seed):
    """Random triangles over several chunks, with exact duplicates at
    several indices (equal-z last-wins ties), against the numpy brute
    force: the kernel and rasterize_xla both match it."""
    from syzygy_tpu.kernels.raster import rasterize_xla

    tris = random_tris(seed, 300, 14)
    for src, dst in [(3, 77), (10, 200), (150, 299)]:
        tris[dst] = tris[src]
    setup = setup_of(tris)
    ref_depth, ref_tri = np_reference_raster(np.asarray(tris), W, H)
    assert_raster_matches(rasterize(setup, W, H), tris, ref_depth, ref_tri)
    assert_raster_matches(rasterize_xla(setup, W, H), tris, ref_depth, ref_tri)


@pytest.mark.parametrize("width,height", [(100, 50), (33, 65), (256, 40)])
def test_non_tile_multiple_target(width, height):
    """Targets that are not tile multiples: the wrapper pads the grid and
    crops, so the result is the matching window of a larger raster and
    agrees with the numpy reference."""
    tris = random_tris(5, 60, 20, width, height, margin=0)
    setup = setup_of(tris, width, height)
    vis = rasterize(setup, width, height)
    assert vis.depth.shape == (height, width)
    assert vis.tri.shape == (height, width)
    ref_depth, ref_tri = np_reference_raster(np.asarray(tris), width, height)
    assert_raster_matches(vis, tris, ref_depth, ref_tri)
    big = rasterize(setup, 256, 128)
    np.testing.assert_array_equal(
        np.asarray(vis.tri), np.asarray(big.tri)[:height, :width]
    )
    depth = rasterize(setup, width, height, depth_only=True).depth
    assert depth.shape == (height, width)
    np.testing.assert_array_equal(np.asarray(depth), np.asarray(vis.depth))


def test_setup_pads_to_whole_chunks():
    """T2 pads to a CHUNK multiple with invalid, empty-bbox slots, and the
    chunk bboxes are the unions of their slots' bboxes."""
    from syzygy_tpu.kernels.raster import CHUNK

    tris = random_tris(2, 37, 10)
    setup = setup_of(tris)
    t2 = setup.coeffs.shape[0]
    assert t2 % CHUNK == 0 and t2 >= 2 * 37
    assert setup.coeffs.shape[1] == 16
    coeffs = np.asarray(setup.coeffs)
    assert (coeffs[2 * 37:, 9] == 0).all()
    assert np.isinf(coeffs[2 * 37:, 10]).all()
    cb = np.asarray(setup.chunk_bbox)
    assert cb.shape == (t2 // CHUNK, 4)
    per = coeffs[:, 10:14].reshape(-1, CHUNK, 4)
    np.testing.assert_array_equal(cb[:, 0], per[..., 0].min(axis=1))
    np.testing.assert_array_equal(cb[:, 1], per[..., 1].max(axis=1))


def _lowered_text(fn, *args, platform):
    import jax

    return jax.jit(fn).trace(*args).lower(lowering_platforms=(platform,)).as_text()


@pytest.mark.parametrize("depth_only", [False, True])
def test_raster_lowers_to_triton_for_cuda(depth_only):
    """Lowered for CUDA (no card needed), the raster is the Triton kernel,
    not the interpreter."""
    setup = setup_of(random_tris(1, 20, 10))
    text = _lowered_text(
        lambda s: rasterize(s, W, H, depth_only=depth_only), setup,
        platform="cuda",
    )
    assert text.count("__gpu$xla.gpu.triton") == 1


def test_raster_unsupported_platform_raises():
    """No silent fallback: a platform with no raster route fails to lower."""
    setup = setup_of(random_tris(1, 20, 10))
    with pytest.raises(Exception, match="platform_index|rocm"):
        _lowered_text(lambda s: rasterize(s, W, H), setup, platform="rocm")


def test_geometry_program_lowers_to_triton_for_cuda():
    """The whole frame program of ``__graft_entry__.entry()`` lowers for CUDA
    with the camera and shadow rasters as Triton kernels."""
    import __graft_entry__ as ge

    fn, args = ge.entry()
    text = _lowered_text(fn, *args, platform="cuda")
    assert text.count("__gpu$xla.gpu.triton") >= 2


def test_setup_and_records_sharded_bitwise():
    """setup_triangles(shard_axis=) and build_resolve_records(shard_axis=)
    claim BITWISE equality with the replicated builds (slot order
    preserved — raster depth-tie order depends on it). Pin every TriSetup
    field and the records table exactly under a CPU shard_map at sp=2 and
    sp=4 (same grid origin on every device, so all copies must equal the
    unsharded result)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P

    from syzygy_tpu.kernels.resolve import (
        build_resolve_records,
        transform_normals,
        transform_positions,
    )
    from syzygy_tpu.scene import (
        default_scene,
        pack_frame_params,
        pack_geometry,
    )
    from syzygy_tpu.scene.pack import prepare_frame_state

    if len(jax.devices()) < 4:
        pytest.skip("needs 4 virtual devices")

    scene, library = default_scene()
    scene.tick(0.0)
    geometry = pack_geometry(scene, library)
    state = prepare_frame_state(pack_frame_params(scene, 2.0))
    proj_view = state.camera.projection @ state.camera.view
    clip, world = transform_positions(
        geometry.positions, geometry.vert_instance, state.models, proj_view
    )
    normals = transform_normals(
        geometry.normals, geometry.vert_instance, state.model_inv_transpose
    )

    def build(shard_axis=None):
        setup = setup_triangles(
            clip,
            geometry.triangles,
            geometry.tri_valid,
            256,
            128,
            cull_keep_sign=+1,
            shard_axis=shard_axis,
        )
        records = build_resolve_records(
            setup, geometry, world, normals, shard_axis=shard_axis
        )
        return (*setup, records)

    ref = [np.asarray(x) for x in build()]

    for sp in (2, 4):
        mesh = Mesh(np.asarray(jax.devices()[:sp]).reshape(sp), ("sp",))
        out = jax.shard_map(
            lambda: build(shard_axis="sp"),
            mesh=mesh,
            in_specs=(),
            out_specs=P(),
            check_vma=False,
        )()
        for name, r, o in zip(
            ("coeffs", "orig_tri", "corner_bary", "corner_w", "chunk_bbox",
             "records"),
            ref,
            out,
        ):
            np.testing.assert_array_equal(
                r, np.asarray(o), err_msg=f"sp={sp} {name}"
            )

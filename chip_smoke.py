"""End-to-end smoke test of the renderer on NVIDIA GPUs, in one process.

    python chip_smoke.py              # phases 1-5 on one GPU
    python chip_smoke.py --multichip  # phase 1 + 6 only, on four GPUs

Phases (each one that fails stops the script with a non-zero exit):

1. device     every JAX device is a GPU; prints the card's name and power
              limit (nvidia-smi), the JAX version, the matmul precision
              and the compile cache directory.
2. raster     the Triton raster kernel against ``rasterize_xla`` (the
              plain-XLA formulation of the same contract) at 1920x1088 on
              the default, chess and dense camera rasters and the sun
              depth raster at 1024^2 and 4096^2, plus a numpy float64
              brute force on 4,096 fixed random pixels; prints both
              timings.
3. frame      the chess flagship at 1920x1080 against the CPU-rendered
              golden (RMSE <= 1e-3), then the default, chess and dense
              frames at the default RenderConfig: finite, with cold
              compile seconds and the median ms/frame.
4. app        ``python -m syzygy_tpu.app`` in-process: 3 frames at
              1920x1080; the PNGs decode and are not constant.
5. serve      the browser viewer on a thread: three /frame.png requests,
              one /api/input drag, the preview frame it causes, then
              /api/stats; every response is 200.
6. multichip  row-sharded frames (dp=1, sp=4) and (dp=2, sp=2) at
              1920x1080 on the default and dense scenes against a
              single-GPU render: bitwise without atmosphere, <= 1.6e-5
              max abs with it.

The last line of standard output is one JSON object,
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``;
it is printed only when every phase passed.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
FRAME_W, FRAME_H = 1920, 1080
CAMERA_W, CAMERA_H = 1920, 1088  # the padded frame the camera raster covers
SUN_DIMS = (1024, 4096)
EDGE_TOL = 1e-4  # barycentric distance within which tri ids may differ
DEPTH_ATOL = 1e-5
SAMPLE_PIXELS = 4096


def log(*parts) -> None:
    print(*parts, flush=True)


class PhaseFailed(AssertionError):
    pass


def check(ok: bool, message: str) -> None:
    if not ok:
        raise PhaseFailed(message)


# ---------------------------------------------------------------------------
# phase 1: device
# ---------------------------------------------------------------------------


def phase_device(jax, want_count: int | None):
    devices = jax.devices()
    check(
        all(d.platform == "gpu" for d in devices),
        f"not a GPU run: {[d.platform for d in devices]}",
    )
    if want_count is not None:
        check(len(devices) >= want_count, f"need {want_count} GPUs, have {len(devices)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        check=True,
    ).stdout.strip()
    log(smi)
    log(f"jax {jax.__version__}; devices {len(devices)} x {devices[0].device_kind}")
    log(f"matmul precision {jax.config.jax_default_matmul_precision}")
    log(
        "compile cache "
        f"{os.environ.get('JAX_COMPILATION_CACHE_DIR') or jax.config.jax_compilation_cache_dir}"
    )
    return smi.splitlines()[0]


# ---------------------------------------------------------------------------
# phase 2: raster
# ---------------------------------------------------------------------------


def camera_setup(geometry, params, width, height):
    from syzygy_tpu.kernels.raster import setup_triangles
    from syzygy_tpu.kernels.resolve import transform_positions
    from syzygy_tpu.scene.pack import prepare_frame_state

    state = prepare_frame_state(params)
    proj_view = state.camera.projection @ state.camera.view
    clip, _ = transform_positions(
        geometry.positions, geometry.vert_instance, state.models, proj_view
    )
    return setup_triangles(
        clip, geometry.triangles, geometry.tri_valid, width, height,
        cull_keep_sign=+1,
    )


def sun_setup(geometry, params, dim):
    import jax.numpy as jnp

    from syzygy_tpu.kernels.raster import setup_triangles
    from syzygy_tpu.kernels.resolve import transform_positions
    from syzygy_tpu.scene.pack import prepare_frame_state

    state = prepare_frame_state(params)
    proj_view = state.camera.projection @ state.camera.view
    _, world = transform_positions(
        geometry.positions, geometry.vert_instance, state.models, proj_view
    )
    world_h = jnp.concatenate([world, jnp.ones_like(world[:, :1])], axis=-1)
    sun = state.directional_lights
    light_pv = sun.projection[0] @ sun.view[0]
    corners = jnp.einsum("tcj,ij->tci", world_h[geometry.triangles], light_pv)
    return setup_triangles(
        None, geometry.triangles,
        geometry.tri_valid & geometry.tri_casts_shadow, dim, dim,
        cull_keep_sign=-1, corner_clip=corners,
    )


def brute_force(coeffs: np.ndarray, ys: np.ndarray, xs: np.ndarray):
    """float64 reference at pixels (ys, xs), independent of the binning:
    every valid slot's barycentric forms, the inside test, depth in [0, 1]
    and the lexicographic max of (depth, slot) — what the serial
    ``z >= current`` walk selects. Returns (depth, tri, edge) where edge is
    the pixel's smallest |barycentric| over the triangles it lies inside or
    within 1e-3 of."""
    c = coeffs.astype(np.float64)
    slots = np.nonzero(c[:, 9] > 0)[0]
    c = c[slots]
    px = (xs + 0.5).astype(np.float64)[:, None]
    py = (ys + 0.5).astype(np.float64)[:, None]
    n = len(xs)
    best_z = np.full(n, -1.0)
    best_t = np.full(n, -1, np.int64)
    edge = np.full(n, np.inf)
    for s in range(0, len(c), 1024):
        cc = c[s : s + 1024].T[:, None, :]
        b0 = cc[0] + cc[1] * px + cc[2] * py
        b1 = cc[3] + cc[4] * px + cc[5] * py
        b2 = 1.0 - b0 - b1
        z = cc[6] + cc[7] * b0 + cc[8] * b1
        m = np.minimum(np.minimum(b0, b1), b2)
        edge = np.minimum(edge, np.where(m > -1e-3, np.abs(m), np.inf).min(axis=1))
        zz = np.where((m >= 0.0) & (z >= 0.0) & (z <= 1.0), z, -1.0)
        blk = zz.max(axis=1)
        last = zz.shape[1] - 1 - np.argmax((zz == blk[:, None])[:, ::-1], axis=1)
        take = (blk >= 0.0) & (blk >= best_z)
        best_z = np.where(take, blk, best_z)
        best_t = np.where(take, slots[s + last], best_t)
    return np.maximum(best_z, 0.0), best_t, edge


def compare_visibility(label, vis, ref_depth, ref_tri, coeffs, ys, xs):
    """Tri ids equal except within EDGE_TOL of an edge; depth within
    DEPTH_ATOL where the ids agree (depth-only rasters: depth within
    DEPTH_ATOL except near an edge). ``ref_*`` are values at (ys, xs)."""
    depth = np.asarray(vis.depth)[ys, xs]
    if vis.tri.size:
        bad = np.asarray(vis.tri)[ys, xs] != ref_tri
    else:
        bad = np.abs(depth - ref_depth) > DEPTH_ATOL
    n_bad = int(bad.sum())
    worst_edge = 0.0
    if n_bad:
        _, _, edge = brute_force(coeffs, ys[bad], xs[bad])
        worst_edge = float(edge.max())
        check(
            worst_edge < EDGE_TOL,
            f"{label}: {n_bad} mismatches, one {worst_edge:.3g} from any edge",
        )
    same = ~bad
    depth_err = float(np.abs(depth[same] - ref_depth[same]).max()) if same.any() else 0.0
    check(depth_err <= DEPTH_ATOL, f"{label}: depth differs by {depth_err:.3g}")
    return {"mismatch": n_bad, "worst_edge": worst_edge, "depth_err": depth_err}


def timed_ms(jax, fn, *args, runs: int = 10) -> float:
    jax.block_until_ready(fn(*args))
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def phase_raster(jax, scenes):
    from syzygy_tpu.kernels.raster import rasterize, rasterize_xla

    cases = {}
    for name in ("default", "flagship", "dense"):
        geometry, params = scenes[name]
        cases[f"camera/{name}"] = (
            jax.jit(camera_setup, static_argnums=(2, 3))(
                geometry, params, CAMERA_W, CAMERA_H
            ),
            CAMERA_W, CAMERA_H, False,
        )
    geometry, params = scenes["default"]
    for dim in SUN_DIMS:
        cases[f"sun/{dim}"] = (
            jax.jit(sun_setup, static_argnums=2)(geometry, params, dim),
            dim, dim, True,
        )
    rng = np.random.default_rng(0)
    for label, (setup, w, h, depth_only) in cases.items():
        kernel = jax.jit(
            lambda s, w=w, h=h, d=depth_only: rasterize(s, w, h, depth_only=d)
        )
        plain = jax.jit(
            lambda s, w=w, h=h, d=depth_only: rasterize_xla(s, w, h, depth_only=d)
        )
        vis = kernel(setup)
        ref = plain(setup)
        coeffs = np.asarray(setup.coeffs)
        # kernel vs rasterize_xla on every pixel
        ys, xs = np.mgrid[0:h, 0:w]
        ys, xs = ys.reshape(-1), xs.reshape(-1)
        ref_tri = np.asarray(ref.tri)[ys, xs] if not depth_only else None
        vs_xla = compare_visibility(
            f"{label} vs xla", vis, np.asarray(ref.depth)[ys, xs], ref_tri,
            coeffs, ys, xs,
        )
        # kernel vs numpy float64 brute force on fixed random pixels
        ys = rng.integers(0, h, SAMPLE_PIXELS)
        xs = rng.integers(0, w, SAMPLE_PIXELS)
        bf_depth, bf_tri, _ = brute_force(coeffs, ys, xs)
        vs_np = compare_visibility(
            f"{label} vs numpy", vis, bf_depth, bf_tri, coeffs, ys, xs
        )
        kernel_ms = timed_ms(jax, kernel, setup)
        xla_ms = timed_ms(jax, plain, setup)
        log(
            f"raster {label}: slots {coeffs.shape[0]}, kernel {kernel_ms:.3f} ms, "
            f"xla {xla_ms:.3f} ms | vs xla {vs_xla} | vs numpy {vs_np}"
        )


# ---------------------------------------------------------------------------
# phase 3: frame
# ---------------------------------------------------------------------------


def frame_config(scene, library):
    import dataclasses

    from syzygy_tpu.renderer import RenderConfig
    from syzygy_tpu.scene import scene_uses_metallic

    config = RenderConfig(width=FRAME_W, height=FRAME_H)
    if not scene_uses_metallic(scene, library):
        # the bounce multiplies to exactly 0: skipping it is bitwise (the
        # app makes the same choice)
        config = dataclasses.replace(config, metallic_reflection=False)
    return config


def phase_frame(jax, scenes, hosts, card):
    parity_frame(scenes)
    frames(jax, scenes, hosts, card)


def parity_frame(scenes):
    from syzygy_tpu.app.scenes import parity_1080p_config
    from syzygy_tpu.renderer import render_frame

    geometry, params = scenes["flagship"]
    golden_path = os.path.join(ROOT, "tests", "goldens", "flagship_1080p.npz")
    golden = np.load(golden_path)["img"].astype(np.float32) / 65535.0
    img = np.asarray(render_frame(geometry, params, parity_1080p_config()))
    d = np.abs(img - golden)
    rmse = float(np.sqrt(np.mean(d**2)))
    # visibility and shadow-map flips differ by O(1) per pixel; split them
    # from the smoothly shaded rest
    flips = d.max(axis=-1) > 0.01
    rest = float(np.sqrt(np.mean(d[~flips] ** 2)))
    log(
        f"frame flagship parity vs CPU golden: RMSE {rmse:.6g}, max abs "
        f"{float(d.max()):.4g}, {int(flips.sum())} px off by > 0.01, "
        f"RMSE {rest:.6g} on the rest"
    )
    check(rmse <= 1e-3, f"flagship 1080p RMSE {rmse} > 1e-3")


def frames(jax, scenes, hosts, card):
    from syzygy_tpu.renderer import render_frame_packed
    from syzygy_tpu.scene import flatten_frame_params, frame_param_spec

    for name in ("default", "flagship", "dense"):
        geometry, params = scenes[name]
        config = frame_config(*hosts[name])
        spec = frame_param_spec(params)
        flat = flatten_frame_params(params, spec)
        t0 = time.perf_counter()
        img = jax.block_until_ready(render_frame_packed(geometry, flat, spec, config))
        cold_s = time.perf_counter() - t0
        check(img.shape == (FRAME_H, FRAME_W, 3), f"{name}: shape {img.shape}")
        check(bool(np.isfinite(np.asarray(img)).all()), f"{name}: non-finite pixels")
        ms = timed_ms(
            jax, lambda f: render_frame_packed(geometry, f, spec, config), flat, runs=5
        )
        log(f"frame {name}: cold {cold_s:.1f} s, median {ms:.2f} ms/frame ({card})")


# ---------------------------------------------------------------------------
# phase 4: app, phase 5: serve
# ---------------------------------------------------------------------------


def phase_app(tmp):
    from syzygy_tpu.app.__main__ import main as app_main
    from syzygy_tpu.utils import read_png

    out = os.path.join(tmp, "frames")
    app_main(
        [
            "--frames", "3", "--width", str(FRAME_W), "--height", str(FRAME_H),
            "--out", out,
        ]
    )
    names = sorted(os.listdir(out))
    check(len(names) == 3, f"app wrote {names}")
    for name in names:
        img = read_png(os.path.join(out, name))
        check(img.shape == (FRAME_H, FRAME_W, 4), f"{name}: shape {img.shape}")
        check(float(img[..., :3].std()) > 1.0, f"{name}: constant image")
    log(f"app: {names} decode, not constant")


def phase_serve(hosts):
    import socket
    import threading
    import urllib.request

    from syzygy_tpu.app.serve import serve
    from syzygy_tpu.utils.png import decode_png

    scene, library = hosts["default"]
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    frames = 6
    errors = []

    def run():
        try:
            serve(scene, library, frame_config(scene, library), port=port, frames=frames)
        except BaseException as e:  # reported by the main thread
            errors.append(e)

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{port}"

    def request(path, body=None):
        data = None if body is None else json.dumps(body).encode()
        for _ in range(600):
            try:
                with urllib.request.urlopen(base + path, data=data, timeout=600) as r:
                    check(r.status == 200, f"{path}: HTTP {r.status}")
                    return r.read()
            except ConnectionRefusedError:
                time.sleep(0.1)
            except urllib.error.URLError as e:
                if not isinstance(e.reason, ConnectionRefusedError):
                    raise
                time.sleep(0.1)
        raise PhaseFailed(f"{path}: server never answered")

    sizes = [decode_png(request("/frame.png")).shape[:2] for _ in range(3)]
    request("/api/input", {"cursor": [12.0, -5.0], "dt": 0.0})
    # the first request after input dispatches the preview frame and
    # answers with the previous one; the next one fetches the preview
    sizes += [decode_png(request("/frame.png")).shape[:2] for _ in range(2)]
    stats = json.loads(request("/api/stats"))
    sizes.append(decode_png(request("/frame.png")).shape[:2])
    thread.join(timeout=60)
    check(not errors, f"serve raised {errors}")
    check(sizes[0] == (FRAME_H, FRAME_W), f"first frame {sizes[0]}")
    check((FRAME_H // 2, FRAME_W // 2) in sizes, f"no preview frame among {sizes}")
    log(f"serve: frames {sizes}, last_ms {stats['last_ms']:.1f}")


# ---------------------------------------------------------------------------
# phase 6: multichip
# ---------------------------------------------------------------------------


def phase_multichip(jax, scenes, hosts):
    """Every (scene, variant, mesh) case renders on its own thread: XLA
    compiles the programs concurrently on the host's cores, and the
    devices run them as they come."""
    import dataclasses
    from concurrent.futures import ThreadPoolExecutor

    from syzygy_tpu.parallel import (
        batch_params,
        make_mesh,
        render_frames_sharded,
        replicate_to_mesh,
    )
    from syzygy_tpu.renderer import render_frame_packed
    from syzygy_tpu.scene import flatten_frame_params, frame_param_spec

    meshes = ((1, 4), (2, 2))
    variants = {}
    for name in ("default", "dense"):
        geometry, params = scenes[name]
        base = frame_config(*hosts[name])
        # two program shapes of the same per-pixel math, whose fusion may
        # differ in the last bits (the repo's bound; measured 0 on H100s)
        variants[name, "atmosphere"] = (geometry, base, params, 1.6e-5)
        variants[name, "no atmosphere"] = (
            geometry,
            dataclasses.replace(base, render_atmosphere=False),
            params._replace(directional_skip_count=np.int32(0)),
            0.0,
        )

    def single(geometry, config, p):
        spec = frame_param_spec(p)
        flat = flatten_frame_params(p, spec)
        return np.asarray(render_frame_packed(geometry, flat, spec, config))

    def sharded(geometry, config, p, dp, sp):
        mesh = make_mesh(dp=dp, sp=sp)
        return np.asarray(
            render_frames_sharded(
                replicate_to_mesh(geometry, mesh), batch_params([p] * dp),
                config, mesh,
            )
        )

    with ThreadPoolExecutor(max_workers=12) as pool:
        singles = {
            key: pool.submit(single, g, c, p)
            for key, (g, c, p, _) in variants.items()
        }
        outs = {
            (key, mesh): pool.submit(sharded, g, c, p, *mesh)
            for key, (g, c, p, _) in variants.items()
            for mesh in meshes
        }
        for (key, (dp, sp)), future in outs.items():
            err = float(np.abs(future.result() - singles[key].result()[None]).max())
            bound = variants[key][3]
            log(
                f"multichip {key[0]} {key[1]} dp={dp} sp={sp}: "
                f"max abs vs one GPU {err:.3g} (bound {bound:g})"
            )
            check(err <= bound, f"{key} dp={dp} sp={sp}: {err}")


# ---------------------------------------------------------------------------


def load_scenes(jax, names):
    from syzygy_tpu.app.scenes import framed_scene
    from syzygy_tpu.runtime import place_on_accelerator
    from syzygy_tpu.scene import pack_frame_params, pack_geometry

    scenes, hosts = {}, {}
    for name in names:
        scene, library = framed_scene(name)
        hosts[name] = (scene, library)
        scenes[name] = (
            place_on_accelerator(pack_geometry(scene, library)),
            pack_frame_params(scene, FRAME_W / FRAME_H),
        )
    return scenes, hosts


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument(
        "--multichip", action="store_true",
        help="run only the four-GPU row-sharding phase",
    )
    args = parser.parse_args(argv)
    if not os.path.isdir(os.path.join(ROOT, "syzygy_tpu")):
        print("chip_smoke.py must run from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import tempfile

    import jax

    import syzygy_tpu  # noqa: F401  (compile cache + matmul precision)

    started = time.perf_counter()

    def phase(name, fn, *a):
        t0 = time.perf_counter()
        log(f"== {name}")
        result = fn(*a)
        log(f"== {name} ok ({time.perf_counter() - t0:.1f} s)")
        return result

    try:
        card = phase("device", phase_device, jax, 4 if args.multichip else None)
        if args.multichip:
            scenes, hosts = phase("scenes", load_scenes, jax, ("default", "dense"))
            phase("multichip", phase_multichip, jax, scenes, hosts)
        else:
            scenes, hosts = phase(
                "scenes", load_scenes, jax, ("default", "flagship", "dense")
            )
            phase("raster", phase_raster, jax, scenes)
            phase("frame", phase_frame, jax, scenes, hosts, card)
            with tempfile.TemporaryDirectory() as tmp:
                phase("app", phase_app, tmp)
            phase("serve", phase_serve, hosts)
    except PhaseFailed as e:
        print(f"FAILED: {e}", file=sys.stderr, flush=True)
        return 1
    devices = jax.devices()
    log(f"all phases passed in {time.perf_counter() - started:.1f} s")
    count = 4 if args.multichip else 1
    print(
        json.dumps(
            {
                "ok": True,
                "device": {
                    "platform": devices[0].platform,
                    "kind": devices[0].device_kind,
                    "count": count,
                },
            }
        ),
        flush=True,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())

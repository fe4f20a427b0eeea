"""Headless driver: the editor frame loop without a window.

Replaces ``editor/editor.cpp:441-779``: ticks the scene (sun animation,
instance animations, scripted fly-camera input), renders each frame through
the jitted frame stages, tracks an FPS ring buffer, and writes PNG frames.
ImGui/GLFW/swapchain are out of scope for a headless engine; the metrics report
stands in for the performance window, ``--save/--load-scene`` for the planned
serialization, and ``--orbit`` for interactive fly input.

Pipelines (``Renderer::RenderingPipelines``, ``renderer.cpp:381-443``):
  deferred            the full G-buffer + lighting + atmosphere frame
  compute-collection  the demo fullscreen compute shaders
                      (gradient_color / matrix_color, renderer.cpp:234-247)

Usage:
    python -m syzygy_tpu.app --frames 8 --width 960 --height 540 \
        --out /tmp/szg --scene default --orbit
"""

from __future__ import annotations

import argparse
import logging
import math
import os
import time

from syzygy_tpu.app.scenes import BUILTIN_SCENES

log = logging.getLogger("syzygy")


def main(argv: list[str] | None = None) -> None:
    """Run the headless app; ``argv`` defaults to ``sys.argv[1:]``."""
    parser = argparse.ArgumentParser(description="syzygy_tpu headless renderer")
    parser.add_argument("--frames", type=int, default=1)
    parser.add_argument("--width", type=int, default=1920)
    parser.add_argument("--height", type=int, default=1080)
    parser.add_argument("--out", type=str, default="frames")
    parser.add_argument(
        "--pipeline",
        type=str,
        default="deferred",
        choices=["deferred", "compute-collection"],
    )
    parser.add_argument(
        "--compute-shader",
        type=str,
        default="gradient",
        choices=["gradient", "matrix", "boolean", "sparse"],
    )
    parser.add_argument(
        "--scene",
        type=str,
        default="default",
        choices=list(BUILTIN_SCENES),
    )
    parser.add_argument("--gltf", type=str, default=None, help="path to .glb/.gltf")
    parser.add_argument("--load-scene", type=str, default=None)
    parser.add_argument("--save-scene", type=str, default=None)
    parser.add_argument("--no-atmosphere", action="store_true")
    parser.add_argument("--debug-lines", action="store_true")
    parser.add_argument("--dump-gbuffer", action="store_true",
                        help="also write G-buffer planes, depth, shadow map "
                             "and atmosphere LUTs as PNGs (TextureDisplay)")
    parser.add_argument("--dump-texture", action="append", default=[],
                        help="write a registered texture asset to PNG by "
                             "name ('all' dumps every one) — the arbitrary-"
                             "asset half of TextureDisplay "
                             "(ui/texturedisplay.cpp:21-80); repeatable")
    parser.add_argument("--list-textures", action="store_true",
                        help="print every registered texture asset and exit")
    parser.add_argument("--fps-target", type=float, default=0.0,
                        help="pace the loop to this FPS by busy-skipping "
                             "frame starts (editor.cpp:605-608); 0 = "
                             "render flat-out")
    parser.add_argument("--shadow-dim", type=int, default=1024)
    parser.add_argument("--skyview-scale", type=int, default=1,
                        help="divide skyview LUT resolution by this factor")
    parser.add_argument("--supersample", type=int, default=1,
                        help="SSAA factor (render at NxN subsamples)")
    parser.add_argument("--oetf", type=str, default="srgb",
                        choices=["srgb", "pure_gamma"])
    parser.add_argument("--dt", type=float, default=1.0 / 60.0)
    parser.add_argument("--time-of-day", type=float, default=None,
                        help="sun time in [0,1); 0.5 = noon")
    parser.add_argument("--sun-speed", type=float, default=100.0)
    parser.add_argument("--camera-index", type=int, default=0,
                        help="active camera (scenes may hold up to 20)")
    parser.add_argument("--camera-pos", type=str, default=None, help="x,y,z")
    parser.add_argument("--camera-look", type=str, default=None, help="x,y,z")
    parser.add_argument("--orbit", action="store_true",
                        help="orbit the camera around the look target")
    parser.add_argument("--input-script", type=str, default=None,
                        help="JSON list of per-frame {keys: 'wasdqe' string, "
                             "cursor: [dx, dy]} entries replayed through the "
                             "fly-camera input handler")
    parser.add_argument("--watch", type=str, default=None,
                        help="live property editing (PropertyTable analog): "
                        "seed this JSON with the scene, then re-render "
                        "whenever the file changes; loops until --frames")
    parser.add_argument("--list-properties", action="store_true",
                        help="print the reflection-discovered property "
                        "table (name / value / reset default — the "
                        "PropertyTable 3-column analog, "
                        "ui/propertytable.hpp:28-226) and exit")
    parser.add_argument("--set", action="append", default=[],
                        metavar="PATH=VALUE",
                        help="set one scene property by dotted path before "
                        "rendering (e.g. camera.fov_degrees=90, "
                        "atmosphere.sun_euler_angles=[1.2,0,0]), or any "
                        "RenderConfig field via config.FIELD=VALUE (the "
                        "pipeline-parameter editor, CLI form); "
                        "PATH=default resets to the discovered default; "
                        "repeatable (see --list-properties)")
    parser.add_argument("--mipmaps", action="store_true",
                        help="trilinear mipmapped textures "
                        "(beyond-parity; reference is single-mip)")
    parser.add_argument("--serve", action="store_true",
                        help="interactive browser viewer: WASDQE+drag fly "
                        "camera and the live property table with "
                        "reset-to-default over localhost HTTP (the "
                        "editor/ImGui loop's headless-native analog — "
                        "editor.cpp:441-779, ui/propertytable.hpp:28-226)")
    parser.add_argument("--port", type=int, default=8731,
                        help="--serve port (default 8731)")
    parser.add_argument("--serve-frames", type=int, default=0,
                        help="stop --serve after N rendered frames "
                        "(0 = run until interrupted; used by tests)")
    parser.add_argument("--preview-scale", type=int, default=2,
                        help="--serve: render 1/N-resolution frames while "
                        "input is live, refine to exact full res at rest "
                        "(1 disables)")
    parser.add_argument("--cpu", action="store_true", help="force CPU backend")
    args = parser.parse_args(argv)

    logging.basicConfig(
        level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s"
    )

    import jax

    if args.cpu:
        # before any jax op: the backend initializes on first use
        jax.config.update("jax_platforms", "cpu")
    device = jax.devices()[0]
    log.info("platform %s (%s)", device.platform, device.device_kind)

    import numpy as np

    from syzygy_tpu.utils import RingBuffer, write_png

    os.makedirs(args.out, exist_ok=True)

    if args.pipeline == "compute-collection":
        _run_compute_collection(args)
        return

    from syzygy_tpu.math.geometry import eulers_from_forward
    from syzygy_tpu.renderer import RenderConfig, render_frame_packed
    from syzygy_tpu.runtime import fetch_frame_u8, place_on_accelerator
    from syzygy_tpu.scene import (
        flatten_frame_params,
        frame_param_spec,
        pack_frame_params,
        pack_geometry,
        scene_uses_metallic,
    )

    scene, library = _build_scene(args)
    if args.list_textures:
        for name in library.names():
            idx = library.lookup(name)
            h, w = library.get(idx).shape[:2]
            print(f"{idx:3d}  {w}x{h}  {name}")
        return
    if args.dump_texture:
        # arbitrary-asset viewer (TextureDisplay, ui/texturedisplay.cpp):
        # any registered texture, written at native resolution
        wanted = (
            library.names()
            if "all" in args.dump_texture
            else args.dump_texture
        )
        for name in wanted:
            idx = library.lookup(name)
            if idx is None:
                log.error("no texture named %r (see --list-textures)", name)
                continue
            safe = name.replace("/", "_")
            tex = library.get(idx)[..., :3]
            if library.is_srgb(idx):
                # re-encode sRGB-decoded color maps for display (the
                # stored texels are linear-light; see serve.texture_png)
                from syzygy_tpu.assets.types import linear_to_srgb

                tex = linear_to_srgb(tex)
            write_png(
                os.path.join(args.out, f"texture_{safe}.png"),
                tex,
            )
            log.info("dumped texture %s", name)
    if args.time_of_day is not None:
        scene.sun_animation.time = args.time_of_day
        scene.sun_animation.frozen = True
    scene.sun_animation.speed = args.sun_speed
    scene.render_atmosphere = not args.no_atmosphere

    if args.camera_index:
        scene.camera_index = args.camera_index

    look_target = np.array([0.0, -6.0, 0.0], np.float32)
    if args.camera_look:
        look_target = np.asarray(
            [float(v) for v in args.camera_look.split(",")], np.float32
        )
    # Default framing: the showcase view (the scene's own default camera
    # starts 2 units from a cube face — fine for the reference's fly-camera
    # editor, useless for headless output).
    eye = np.array([18.0, -16.0, -22.0], np.float32)
    if args.camera_pos:
        eye = np.asarray([float(v) for v in args.camera_pos.split(",")], np.float32)
    scene.camera.position = tuple(eye)
    scene.camera.euler_angles = tuple(
        np.asarray(eulers_from_forward(look_target - eye))
    )
    config_sets = [s for s in args.set if s.startswith("config.")]
    scene_sets = [s for s in args.set if not s.startswith("config.")]
    if scene_sets or args.list_properties:
        from syzygy_tpu.app.properties import apply_set, discover, format_table

        for spec in scene_sets:
            path = apply_set(scene, spec)
            log.info("set %s", path)
        if args.list_properties:
            print(format_table(discover(scene)))
            return
    scene.tick(0.0)

    config = RenderConfig(
        width=args.width,
        height=args.height,
        shadow_dim=args.shadow_dim,
        skyview_width=2048 // args.skyview_scale,
        skyview_height=1024 // args.skyview_scale,
        render_atmosphere=not args.no_atmosphere,
        debug_lines=args.debug_lines,
        supersample=args.supersample,
        oetf=args.oetf,
        # static skip is bitwise-identical when no material is metallic
        metallic_reflection=scene_uses_metallic(scene, library),
    )
    # --set config.FIELD=VALUE edits any RenderConfig field by reflection
    # (the pipeline push-constant editor, CLI form; VALUE "default" resets)
    if config_sets:
        from syzygy_tpu.app.properties import apply_config_field

        for spec in config_sets:
            path, _, text = spec.partition("=")
            config = apply_config_field(
                config, path[len("config."):].strip(), text.strip()
            )
            log.info("set %s", path)
    if args.serve:
        from syzygy_tpu.app.serve import serve

        serve(
            scene,
            library,
            config,
            port=args.port,
            mipmaps=args.mipmaps,
            frames=args.serve_frames,
            preview_scale=args.preview_scale,
        )
        return
    geometry_host = pack_geometry(scene, library, mipmaps=args.mipmaps)
    geometry = place_on_accelerator(geometry_host)
    aspect = args.width / args.height
    params = pack_frame_params(scene, aspect, debug_lines=args.debug_lines)
    spec = frame_param_spec(params)
    flat_buf = np.empty(spec.total, np.float32)

    input_script = None
    if args.input_script:
        import json

        with open(args.input_script) as f:
            input_script = json.load(f)

    fps_history = RingBuffer()
    orbit_radius = None
    if args.orbit:
        eye0 = np.asarray(scene.camera.position, np.float32)
        orbit_radius = float(np.linalg.norm((eye0 - look_target)[[0, 2]]))
        orbit_height = float(eye0[1])
        orbit_phase = math.atan2(
            eye0[2] - look_target[2], eye0[0] - look_target[0]
        )

    log.info(
        "rendering %d frame(s) at %dx%d on %s",
        args.frames,
        args.width,
        args.height,
        jax.default_backend(),
    )
    watch_mtime = None
    if args.watch:
        from syzygy_tpu.scene.serialize import load_scene, save_scene

        if not os.path.exists(args.watch):
            save_scene(args.watch, scene)
            log.info("seeded %s — edit it to re-render live", args.watch)
        watch_mtime = os.stat(args.watch).st_mtime
        mesh_by_name = {
            i.mesh.name: i.mesh for i in scene.geometry if i.mesh is not None
        }

    t_total = time.perf_counter()
    next_frame_t = time.perf_counter()
    for frame_idx in range(args.frames):
        if args.fps_target > 0.0:
            # frame pacing: busy-skip against 1/fpsTarget like the
            # reference's editor loop (editor.cpp:605-608)
            while time.perf_counter() < next_frame_t:
                time.sleep(0.0005)
            next_frame_t = max(
                next_frame_t + 1.0 / args.fps_target, time.perf_counter() - 1.0
            )
        t0 = time.perf_counter()
        if args.watch and frame_idx > 0:
            # block until the watched file changes, then hot-reload every
            # property (the live-editing loop the reference drives through
            # ImGui property tables, ui/propertytable.hpp:28-226)
            while os.stat(args.watch).st_mtime == watch_mtime:
                time.sleep(0.25)
            watch_mtime = os.stat(args.watch).st_mtime
            try:
                scene = load_scene(args.watch, mesh_by_name.get)
                geometry_host = pack_geometry(
                    scene, library, mipmaps=args.mipmaps
                )
                geometry = place_on_accelerator(geometry_host)
                log.info("reloaded %s", args.watch)
            except Exception as e:  # keep rendering the last good scene
                log.error("reload failed (%s); keeping previous scene", e)
        if input_script:
            entry = input_script[frame_idx % len(input_script)]
            scene.handle_input(
                args.dt,
                cursor_delta=tuple(entry.get("cursor", (0.0, 0.0))),
                keys=frozenset(entry.get("keys", "")),
            )
        if args.orbit:
            angle = orbit_phase + frame_idx * 2.0 * math.pi / max(args.frames, 1)
            eye = look_target + np.array(
                [
                    orbit_radius * math.cos(angle),
                    orbit_height - look_target[1],
                    orbit_radius * math.sin(angle),
                ],
                np.float32,
            )
            scene.camera.position = tuple(eye)
            scene.camera.euler_angles = tuple(
                np.asarray(eulers_from_forward(look_target - eye))
            )
        params = pack_frame_params(scene, aspect, debug_lines=args.debug_lines)
        flat = flatten_frame_params(params, spec, flat_buf)
        # u8 quantization on device (bitwise-equal to write_png's host
        # quantize): the device-to-host copy moves 1 byte per channel
        image = fetch_frame_u8(
            render_frame_packed(geometry, flat, spec, config)
        )
        dt = time.perf_counter() - t0
        if frame_idx == 0:
            log.info("first frame (incl. compile): %.1fs", dt)
            # Draw Results table (ui/engineui.cpp:111-126) — headless log
            # analog; recomputed only when the dispatched work can change.
            from syzygy_tpu.renderer.stats import frame_draw_stats

            for name, stat in frame_draw_stats(
                params, geometry_host, config
            ).items():
                log.info("draw results [%s]: %s", name, stat)
        else:
            fps_history.write(1.0 / max(dt, 1e-9))
        write_png(os.path.join(args.out, f"frame_{frame_idx:04d}.png"), image)
        scene.tick(args.dt)

    log.info("wrote %d frames to %s", args.frames, args.out)
    if args.frames > 1:
        log.info("fps (steady, incl. host sync + png): %s", fps_history.report())
    log.info("total %.1fs", time.perf_counter() - t_total)

    if args.save_scene:
        from syzygy_tpu.scene.serialize import save_scene

        save_scene(args.save_scene, scene)
        log.info("saved scene to %s", args.save_scene)

    if args.dump_gbuffer:
        _dump_gbuffer(args, geometry, params, config)


def _dump_gbuffer(args, geometry, params, config) -> None:
    """TextureDisplay analog (``ui/texturedisplay.*``): write intermediate
    targets as PNGs for inspection."""
    import numpy as np

    from syzygy_tpu.kernels.atmosphere import (
        compute_skyview_lut,
        compute_transmittance_lut,
        METERS_PER_MM,
    )
    import jax.numpy as jnp

    from syzygy_tpu.renderer.frame import _stage_geometry
    from syzygy_tpu.utils import write_png

    state, vis, gbuffer, shadow_maps = _stage_geometry(geometry, params, config)

    def norm01(x):
        x = np.asarray(x, np.float32)
        lo, hi = x.min(), x.max()
        return (x - lo) / max(hi - lo, 1e-9)

    h, w = config.height, config.width
    out = args.out
    write_png(f"{out}/gbuffer_diffuse.png", np.asarray(gbuffer.diffuse)[:h, :w, :3])
    write_png(f"{out}/gbuffer_specular.png", np.asarray(gbuffer.specular)[:h, :w, :3])
    write_png(
        f"{out}/gbuffer_normal.png",
        np.asarray(gbuffer.normal)[:h, :w, :3] * 0.5 + 0.5,
    )
    write_png(
        f"{out}/gbuffer_worldpos.png",
        norm01(np.asarray(gbuffer.world_position)[:h, :w, :3]),
    )
    write_png(f"{out}/gbuffer_orm.png", np.asarray(gbuffer.orm)[:h, :w, :3])
    write_png(f"{out}/depth.png", norm01(np.asarray(vis.depth)[:h, :w]))
    write_png(f"{out}/shadow_map_0.png", norm01(np.asarray(shadow_maps[0])))
    t_lut = compute_transmittance_lut(state.atmosphere)
    write_png(f"{out}/transmittance_lut.png", np.asarray(t_lut))
    origin = state.camera.position[:3] / METERS_PER_MM
    origin = origin * jnp.asarray([1.0, -1.0, 1.0]) + jnp.asarray(
        [0.0, state.atmosphere.planet_radius_mm, 0.0]
    )
    sky = compute_skyview_lut(
        state.atmosphere, origin, t_lut,
        width=config.skyview_width, height=config.skyview_height,
    )
    write_png(f"{out}/skyview_lut.png", norm01(np.asarray(sky)))
    log.info("dumped G-buffer/LUT textures to %s", out)


def _run_compute_collection(args) -> None:
    """Config-ladder entry 1: fullscreen demo compute passes + OETF
    (``ComputeCollectionPipeline``, ``renderer/pipelines.cpp:223-380``)."""
    import jax
    import numpy as np

    from syzygy_tpu.kernels.transfer import (
        boolean_push,
        gradient_color,
        matrix_color,
        oetf_pure_gamma,
        oetf_srgb,
        sparse_push,
    )
    from syzygy_tpu.utils import write_png

    w, h = args.width, args.height

    @jax.jit
    def frame():
        if args.compute_shader == "gradient":
            img = gradient_color(w, h)
        elif args.compute_shader == "boolean":
            rng = np.random.default_rng(1)
            img = boolean_push(w, h, rng.integers(0, 2, (4, 4)))
        elif args.compute_shader == "sparse":
            img = sparse_push(w, h, (1.0, 0.3, 0.05, 1.0), (0.05, 0.1, 0.6, 1.0))
        else:
            rng = np.random.default_rng(0)
            img = matrix_color(
                w,
                h,
                rng.uniform(0, 1, (4, 4)).astype(np.float32),
                rng.uniform(0, 1, (4, 4)).astype(np.float32),
                rng.uniform(0, 1, (4, 4)).astype(np.float32),
            )
        rgb = img[..., :3]
        return oetf_srgb(rgb) if args.oetf == "srgb" else oetf_pure_gamma(rgb)

    image = np.asarray(frame())
    path = os.path.join(args.out, "compute_0000.png")
    write_png(path, image)
    log.info("compute-collection (%s): wrote %s", args.compute_shader, path)


def _build_scene(args):
    if args.load_scene:
        from syzygy_tpu.assets import (
            TextureLibrary,
            cube_mesh,
            plane_mesh,
            register_default_textures,
            sphere_mesh,
        )
        from syzygy_tpu.scene.serialize import load_scene

        library = TextureLibrary()
        material = register_default_textures(library)
        meshes = {
            "mesh_Cube": cube_mesh(material),
            "mesh_Plane": plane_mesh(material),
            "mesh_Sphere": sphere_mesh(material),
        }
        return load_scene(args.load_scene, meshes.__getitem__), library
    if args.gltf:
        from syzygy_tpu.assets.gltf import load_gltf_scene

        return load_gltf_scene(args.gltf)
    from syzygy_tpu.app.scenes import builtin_scene

    return builtin_scene(args.scene)


if __name__ == "__main__":
    main()

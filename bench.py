"""Benchmark: the full deferred + atmosphere frame at 1920x1080 on one GPU.

Prints ONE JSON line: {"metric", "value", "unit", "device", "extra"} with
the median ms/frame of the default scene as the value and the chess and
dense scenes in "extra". Each frame is timed on the host clock from the
params upload to ``block_until_ready`` of the image, in one process; the
first frame of each scene (compilation) is reported separately.

Refuses to run anywhere but a GPU: a CPU number is not a device number.
"""

import json
import sys
import time

import numpy as np


def _measure_scene(name: str, config, frames: int) -> dict:
    import dataclasses

    import jax

    from syzygy_tpu.app.scenes import framed_scene
    from syzygy_tpu.renderer.frame import render_frame_packed
    from syzygy_tpu.runtime import place_on_accelerator
    from syzygy_tpu.scene import (
        flatten_frame_params,
        frame_param_spec,
        pack_frame_params,
        pack_geometry,
        scene_uses_metallic,
    )

    scene, library = framed_scene(name)
    scene.sun_animation.frozen = False
    scene.sun_animation.speed = 5000.0
    if not scene_uses_metallic(scene, library):
        # the bounce multiplies to exactly 0 -> skipping is bitwise-identical
        config = dataclasses.replace(config, metallic_reflection=False)
    aspect = config.width / config.height
    geometry = place_on_accelerator(pack_geometry(scene, library))
    params = pack_frame_params(scene, aspect)
    spec = frame_param_spec(params)
    buf = np.empty(spec.total, np.float32)

    def frame():
        flat = flatten_frame_params(pack_frame_params(scene, aspect), spec, buf)
        img = render_frame_packed(geometry, jax.device_put(flat), spec, config)
        jax.block_until_ready(img)
        scene.tick(1.0 / 60.0)
        return img

    t0 = time.perf_counter()
    img = frame()
    first_s = time.perf_counter() - t0
    if not bool(np.isfinite(np.asarray(img)).all()):
        raise RuntimeError(f"{name}: non-finite pixels")
    times = []
    for _ in range(frames):
        t0 = time.perf_counter()
        frame()
        times.append((time.perf_counter() - t0) * 1000.0)
    return {
        "median_ms": float(np.median(times)),
        "p90_ms": float(np.percentile(times, 90)),
        "n": len(times),
        "first_frame_s": first_s,
    }


def main() -> int:
    import jax

    device = jax.devices()[0]
    if device.platform != "gpu":
        print(f"bench.py needs a GPU; found {device.platform}", file=sys.stderr)
        return 1

    from syzygy_tpu.renderer import RenderConfig

    config = RenderConfig(width=1920, height=1080)
    results = {
        name: _measure_scene(name, config, frames)
        for name, frames in (("default", 40), ("flagship", 20), ("dense", 20))
    }
    print(
        json.dumps(
            {
                "metric": "ms/frame, 1920x1080 full deferred+atmosphere frame",
                "value": results["default"]["median_ms"],
                "unit": "ms",
                "device": {
                    "platform": device.platform,
                    "kind": device.device_kind,
                    "count": len(jax.devices()),
                },
                "extra": results,
            }
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())

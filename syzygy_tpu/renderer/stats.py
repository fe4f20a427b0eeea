"""Per-frame draw statistics (``DrawResultsGraphics``).

The reference counts draw calls / vertices / indices when recording the
debug-lines pipeline (``renderer/pipelines.hpp:39-44``, filled at
``renderer/pipelines.cpp:577-580``, reset+stored per frame at
``renderer/renderer.cpp:453-474``) and surfaces them read-only in the
engine UI (``ui/engineui.cpp:111-126``). This module computes the same
counters host-side — the device frame is a handful of whole-soup dispatches
rather than per-mesh command-buffer draws, so each dispatch counts as one
"draw call" over the triangles it actually consumes:

* ``gbuffer``  — the camera visibility raster: 1 call over every valid
  triangle of the packed soup.
* ``shadows``  — one call per shadow-map raster that will actually run,
  replicating ``renderer/frame.py::_shadow_pass``'s activity gate (map 0
  always rasters; other directionals skip when ``emits == 0`` or, under
  ``shadowless_strength_eps``, when too dim; spots up to the map budget).
  Each call consumes the shadow-casting subset of the soup.
* ``debug_lines`` — reference-exact semantics: 1 call, vertices = indices
  = 2 x segment count (``pipelines.cpp:577-580``).

Everything here is numpy/host math over the already-built ``FrameParams``
(no device work), so the app can log it every frame for free.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class DrawStats(NamedTuple):
    """``DrawResultsGraphics`` (``renderer/pipelines.hpp:39-44``)."""

    draw_calls: int
    vertices_drawn: int
    indices_drawn: int

    def __str__(self) -> str:  # engineui.cpp:111-126 row labels
        return (
            f"draw calls {self.draw_calls}, vertices {self.vertices_drawn}, "
            f"indices {self.indices_drawn}"
        )


def _add(a: DrawStats, b: DrawStats) -> DrawStats:
    return DrawStats(
        a.draw_calls + b.draw_calls,
        a.vertices_drawn + b.vertices_drawn,
        a.indices_drawn + b.indices_drawn,
    )


def frame_draw_stats(params, geometry, config) -> dict[str, DrawStats]:
    """Counters for every dispatch the next ``render_frame`` will issue.

    ``params`` is the frame's ``FrameParams``, ``geometry`` the packed
    ``GeometryStatic`` (pass the HOST copy, before
    ``place_on_accelerator`` — the boolean reductions are tiny and need
    no device round trip), ``config`` the
    ``RenderConfig``.
    """
    from syzygy_tpu.renderer.frame import N_DIRECTIONAL
    from syzygy_tpu.scene.atmosphere import bake_directional

    n_tris = int(np.asarray(geometry.tri_valid).sum())
    n_shadow_tris = int(
        (np.asarray(geometry.tri_valid) & np.asarray(geometry.tri_casts_shadow)).sum()
    )
    n_verts = int(np.asarray(geometry.positions).shape[0])

    stats: dict[str, DrawStats] = {}
    stats["gbuffer"] = DrawStats(1, n_verts, 3 * n_tris)

    # Shadow raster activity gate — host mirror of _shadow_pass
    # (renderer/frame.py): same eps formula over the baked sun/moon.
    d = bake_directional(params.atmosphere, params.bounds_min, params.bounds_max)
    color = np.asarray(d.color)[:, :3]
    strength = np.asarray(d.strength)
    forward = np.asarray(d.forward)[:, :3]
    dir_int = np.max(np.abs(color), axis=-1) * np.abs(strength)
    eps = config.shadowless_strength_eps
    if eps > 0.0:
        from syzygy_tpu.math.geometry import WORLD_UP

        daylight = np.clip(
            np.sum(-forward * np.asarray(WORLD_UP), axis=-1), 0.0, 1.0
        )
        dir_needs = dir_int >= eps * float(np.sum(dir_int * daylight))
    else:
        dir_needs = dir_int != 0.0
    dir_needs[0] = True  # sun always rasters (the sky pass samples map 0)
    n_maps = config.n_shadow_maps
    n_dir = int(np.sum(dir_needs[: min(N_DIRECTIONAL, n_maps)]))
    n_spot = min(int(params.spot_count), max(0, n_maps - N_DIRECTIONAL))
    shadow_calls = n_dir + n_spot
    stats["shadows"] = DrawStats(
        shadow_calls, shadow_calls * n_verts, shadow_calls * 3 * n_shadow_tris
    )

    # Debug lines: reference-exact (pipelines.cpp:577-580 — one call,
    # vertex buffer = 2 endpoints per segment, one index per endpoint).
    n_seg = int(np.asarray(params.debug_valid).sum())
    stats["debug_lines"] = (
        DrawStats(1, 2 * n_seg, 2 * n_seg) if n_seg else DrawStats(0, 0, 0)
    )

    stats["total"] = DrawStats(0, 0, 0)
    for key in ("gbuffer", "shadows", "debug_lines"):
        stats["total"] = _add(stats["total"], stats[key])
    return stats

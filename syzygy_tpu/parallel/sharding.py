"""Multi-device rendering: image-space + frame-batch sharding over a mesh.

The reference is single-GPU (SURVEY.md §2c); the natural scaling axes for a
renderer are:

* ``sp`` (spatial): shard the pixel grid's row-tiles across devices. Every
  per-pixel pass (raster, resolve, lighting, sky) is local to its rows; only
  the final image gather crosses devices — it follows from the output
  sharding, no explicit collectives needed. Scene state and geometry are
  replicated (a few MB; broadcast once). The camera setup's O(T) slot math
  and the shadow-map lights ALSO partition over ``sp`` (rejoined via
  ``all_gather``) so triangle-heavy scenes don't replicate their setup per
  device.
* ``dp`` (data/frame): independent frames (cameras/time steps) across devices,
  e.g. offline animation or multi-view rendering.

Atmosphere LUTs are recomputed per device rather than sharded and gathered:
they are small next to the per-pixel work, and recompute avoids a
collective on the frame critical path. The raster evaluates global pixel
coordinates, so sharded output without atmosphere is BITWISE equal to the
single-device frame. The per-device frame batch is never vmapped (see
:func:`_map_frames`), and the frame runs as TWO chained shard_map programs
(geometry, then lighting+sky) matching the single-device chaining. The
one-program formulation stays under ``SHARDED_SPLIT_PROGRAMS=False``: it is
the one the vma checker can trace (the split path's replicated-boundary
out_specs cannot be proven, because all_gather results are conservatively
sp-varying to the checker).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from syzygy_tpu.renderer.frame import (
    RenderConfig,
    _defers_resolve,
    _geometry_body,
    _stage_lighting_sky,
    render_frame_rows,
)
from syzygy_tpu.scene.pack import FrameParams, GeometryStatic


# Two chained programs (production: matches single-device partitioning)
# vs one fused program (vma-checkable — see module docstring).
SHARDED_SPLIT_PROGRAMS = True


def make_mesh(dp: int = 1, sp: int = 1, devices=None) -> Mesh:
    """A (dp, sp) device mesh; dp x sp must equal the device count used."""
    devices = devices if devices is not None else jax.devices()[: dp * sp]
    if len(devices) != dp * sp:
        raise ValueError(f"need {dp * sp} devices, have {len(devices)}")
    import numpy as np

    return Mesh(np.asarray(devices).reshape(dp, sp), ("dp", "sp"))


def _map_frames(one, args_tree):
    """Apply ``one`` over the leading frame-batch axis WITHOUT vmap.

    vmap is the wrong tool for the per-device frame batch: a batched
    ``lax.cond`` predicate lowers to select-and-execute-BOTH-branches (the
    shadow pass's active-light loop and skips would run for every light),
    and the batch dim lands on every per-pixel tensor. B == 1 (the common
    case: dp shards frames) calls straight through; B > 1 uses
    ``lax.map`` — a scan whose body stays UNBATCHED, keeping conds
    structural and layouts flat."""
    b = jax.tree.leaves(args_tree)[0].shape[0]
    if b == 1:
        out = one(jax.tree.map(lambda x: x[0], args_tree))
        return jax.tree.map(lambda x: x[None], out)
    return jax.lax.map(one, args_tree)


def _local_rows(config: RenderConfig, sp: int) -> int:
    from syzygy_tpu.kernels.common import round_up
    from syzygy_tpu.kernels.raster import TILE_H

    # Pad the row axis up to a multiple of sp * TILE_H so EVERY (height, sp)
    # combination shards: each device renders an equal whole-tile row block,
    # and rows beyond the real framebuffer are off-screen (no geometry
    # coverage, sky rays below the frustum) and cropped away after the
    # gather. At 1920x1080 (padded_height 1088 = 68 tile rows) this costs
    # 0 / 0 / 4 junk tile rows at sp=2/4/8 — bounded waste, against which
    # the alternative (refusing non-divisible shapes) would leave the
    # production shape un-shardable at sp=8.
    return round_up(config.padded_height, sp * TILE_H) // sp


@functools.partial(jax.jit, static_argnames=("config", "mesh"))
def _sharded_geometry(
    geometry: GeometryStatic,
    params_batch: FrameParams,
    config: RenderConfig,
    mesh: Mesh,
):
    """Program 1 of the split sharded frame: prepare + vertex transform +
    shadow rasters (light-parallel over sp) + camera raster + records.

    Outputs: state / records / shadow maps are sp-replicated (their
    out_specs omit ``sp``; every device computed the identical value —
    state from replicated params, records and maps through all_gathers);
    the visibility buffer (or resolved G-buffer) is row-sharded."""
    sp = mesh.shape["sp"]
    rows = _local_rows(config, sp)

    def fn(geometry, params_local):
        row0 = jax.lax.axis_index("sp") * rows

        def one(params):
            return _geometry_body(
                geometry, params, config, row0, rows,
                shadow_shard_axis="sp",
            )

        return _map_frames(one, params_local)

    defers = _defers_resolve(config, geometry)
    out_specs = (
        P("dp"),  # FrameState
        P("dp", "sp"),  # VisibilityBuffer rows
        P("dp") if defers else P("dp", "sp"),  # records | G-buffer rows
        P("dp"),  # shadow maps
    )
    return jax.shard_map(
        fn,
        mesh=mesh,
        in_specs=(P(), P("dp")),
        out_specs=out_specs,
        check_vma=False,
    )(geometry, params_batch)


@functools.partial(jax.jit, static_argnames=("config", "mesh"))
def _sharded_finish(
    geometry: GeometryStatic,
    state,
    vis,
    gbuffer,  # records (T2, 49) when the resolve is deferred
    shadow_maps,
    config: RenderConfig,
    mesh: Mesh,
):
    """Program 2: resolve + lighting + sky per row chunk (the single-chip
    production formulation of ``_stage_lighting_sky``), on each device's
    row block. Crops to the real framebuffer inside the program."""
    sp = mesh.shape["sp"]
    rows = _local_rows(config, sp)
    defers = _defers_resolve(config, geometry)

    def fn(geometry, state_l, vis_l, gb_l, maps_l):
        row0 = jax.lax.axis_index("sp") * rows

        def one(args):
            state1, vis1, gb1, maps1 = args
            if defers:
                return _stage_lighting_sky.__wrapped__(
                    state1, vis1.depth, None, maps1, config, row0,
                    vis1, gb1, geometry,
                )
            return _stage_lighting_sky.__wrapped__(
                state1, vis1.depth, gb1, maps1, config, row0
            )

        return _map_frames(one, (state_l, vis_l, gb_l, maps_l))

    out = jax.shard_map(
        fn,
        mesh=mesh,
        in_specs=(
            P(),
            P("dp"),
            P("dp", "sp"),
            P("dp") if defers else P("dp", "sp"),
            P("dp"),
        ),
        out_specs=P("dp", "sp", None, None),
        check_vma=False,
    )(geometry, state, vis, gbuffer, shadow_maps)
    return out[:, : config.height, : config.width]


@functools.partial(jax.jit, static_argnames=("config", "mesh"))
def _render_frames_sharded_mono(
    geometry: GeometryStatic,
    params_batch: FrameParams,
    config: RenderConfig,
    mesh: Mesh,
) -> jnp.ndarray:
    """One-program formulation (vma-checkable — module docstring)."""
    sp = mesh.shape["sp"]
    rows = _local_rows(config, sp)

    def shard_fn(geometry, params_local):
        # params_local: leading dim B/dp; render each frame's local row block
        row0 = jax.lax.axis_index("sp") * rows

        def one_frame(params):
            # rows shard over sp; shadow lights + triangle setup also
            # partition over sp and rejoin via all_gather
            return render_frame_rows(
                geometry, params, config, row0, rows,
                shadow_shard_axis="sp",
            )

        return _map_frames(one_frame, params_local)

    fn = jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P(), P("dp")),
        out_specs=P("dp", "sp", None, None),
        # Trace-time spec checking: the raster pallas_call out_shapes carry
        # `vma` (kernels/raster.py::_out_vma propagates the union of the
        # inputs' varying axes) and every loop carry that starts from
        # zeros/ones is pcast up via kernels.common.match_vma, so the whole
        # frame graph type-checks (tests/test_frame.py::
        # test_sharded_vma_checked traces the 1080p shape this way).
        check_vma=True,
    )
    out = fn(geometry, params_batch)  # (B, h_pad, w_pad, 3)
    return out[:, : config.height, : config.width]


def render_frames_sharded(
    geometry: GeometryStatic,
    params_batch: FrameParams,  # leaves have leading batch dim B (B % dp == 0)
    config: RenderConfig,
    mesh: Mesh,
) -> jnp.ndarray:
    """Render a batch of frames over the (dp, sp) mesh.

    Returns (B, height, width, 3). Rows are sharded over ``sp`` during
    rendering; XLA inserts the gather implied by the output sharding.
    Two chained device programs (geometry, then lighting+sky) exactly like
    the single-chip path — the host enqueues both without syncing."""
    if not SHARDED_SPLIT_PROGRAMS:
        return _render_frames_sharded_mono(geometry, params_batch, config, mesh)
    state, vis, gbuffer, shadow_maps = _sharded_geometry(
        geometry, params_batch, config, mesh
    )
    return _sharded_finish(
        geometry, state, vis, gbuffer, shadow_maps, config, mesh
    )


def replicate_to_mesh(tree, mesh: Mesh):
    """Place a pytree replicated across the mesh (geometry broadcast)."""
    sharding = NamedSharding(mesh, P())
    return jax.device_put(tree, sharding)


def batch_params(params_list) -> FrameParams:
    """Stack per-frame FrameParams into a leading batch axis."""
    return jax.tree.map(lambda *xs: jnp.stack([jnp.asarray(x) for x in xs]), *params_list)

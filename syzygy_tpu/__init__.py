"""syzygy_tpu — a JAX rebuild of the Syzygy deferred renderer.

The reference (EllarBooher/Syzygy) is a C++20 Vulkan 1.3 deferred renderer +
editor. This package reproduces its capabilities as a JAX/XLA/Pallas
engine: the Vulkan graphics pipeline becomes a tile-binned software rasterizer
(a Pallas visibility-buffer kernel) plus vectorized per-pixel passes, and the
frame — vertex transform, raster, G-buffer resolve, shadow maps, deferred
PBR lighting, Hillaire atmosphere, tonemap, OETF — runs as chained jitted
programs on one GPU (or row-sharded over several).

Layer map (mirrors SURVEY.md §7):
  math/     — geometry conventions, projections, transforms (geometry/ in ref)
  scene/    — Atmosphere, Camera, lights, instanced meshes  (renderer/scene.*)
  assets/   — glTF loading, procedural default assets       (assets/)
  kernels/  — Pallas + jnp GPU programs                     (shaders/)
  renderer/ — per-pass orchestration, frame graph           (renderer/)
  parallel/ — multi-device image-space sharding             (no ref equivalent)
  app/      — headless driver loop, metrics                 (editor/)
"""

import os as _os

import jax as _jax

# Persistent compilation cache (the analog of the reference's runtime
# SPIR-V loading, renderer/shaders.cpp:491-641: its shaders never recompile
# across runs; neither should our programs). JAX_COMPILATION_CACHE_DIR, when
# set, is honored by jax itself and nothing is set here; otherwise the cache
# lives at a fixed path inside the checkout (the path is part of the key).
if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    _jax.config.update(
        "jax_compilation_cache_dir",
        _os.path.join(
            _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
            ".jax_cache",
        ),
    )
    _jax.config.update("jax_persistent_cache_min_compile_time_secs", 1)

# Geometry (4x4 transforms, vertex transforms, LUT math) needs true float32:
# on the GPU a float32 matmul may otherwise run in TF32 (~3 decimal digits),
# which visibly warps projections. Kernels that can tolerate lower precision
# opt in locally via preferred_element_type / explicit precision instead.
_jax.config.update("jax_default_matmul_precision", "highest")

__version__ = "0.1.0"

"""Test harness: run everything on a virtual 8-device CPU mesh.

Tests run on the CPU (``JAX_PLATFORMS=cpu``, also forced here before any
computation). The raster kernel lowers for the CPU through the Pallas
interpreter; its compiled Triton form runs on the GPU through
``chip_smoke.py``.
"""

import os

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

jax.config.update("jax_platforms", "cpu")

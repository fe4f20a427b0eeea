"""Device placement and presentation helpers."""

from __future__ import annotations

import jax


def accelerator_device():
    """The default backend's first device (the GPU in production; the CPU
    when ``JAX_PLATFORMS=cpu``)."""
    return jax.devices()[0]


def place_on_accelerator(tree):
    """Commit a pytree to the default device (geometry upload path)."""
    return jax.device_put(tree, accelerator_device())


_QUANT_U8 = None


def fetch_frame_u8(image):
    """Quantize a [0,1] float frame to u8 ON ITS DEVICE, then fetch it.

    Matches the host-side ``(clip(x,0,1)*255+0.5).astype(u8)``: bitwise on
    CPU (float->int conversion truncates toward zero in both XLA and numpy,
    and the pre-truncation arithmetic is the same IEEE f32 expression —
    tests/test_runtime.py pins edge values). The device-to-host copy moves
    1 byte per channel instead of 4, and it is the swapchain-format analog:
    the reference presents B8G8R8A8_UNORM, not a float target
    (``editor/graphicscontext.cpp`` swapchain format), so the 8-bit hop is
    where presentation happens there too.
    """
    global _QUANT_U8
    import numpy as np

    if _QUANT_U8 is None:
        import jax.numpy as jnp

        _QUANT_U8 = jax.jit(
            lambda x: (jnp.clip(x, 0.0, 1.0) * 255.0 + 0.5).astype(jnp.uint8)
        )
    return np.asarray(_QUANT_U8(image))

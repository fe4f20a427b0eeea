"""Builtin scene factory shared by the CLI (``--scene``) and the viewer's
runtime loader (``/api/load`` with a builtin name)."""

from __future__ import annotations

BUILTIN_SCENES = ("default", "sphere", "chessboard", "flagship", "dense")


def builtin_scene(name: str):
    """Construct one of the named builtin scenes -> (scene, library).

    ``default`` = the reference's editor default scene (2 cubes + floor +
    red spotlight, ``editor.cpp:507-568``); ``chessboard`` = the textured
    showcase board; ``flagship`` = the lathed-chess ABeautifulGame
    stand-in; ``sphere`` = a single 5x-scaled UV sphere; ``dense`` = an
    8x8 field of 4,096-triangle spheres (262k triangles, the raster-bound
    stress scene)."""
    if name == "default":
        from syzygy_tpu.scene import default_scene

        return default_scene()
    if name == "chessboard":
        from syzygy_tpu.assets.showcase import chessboard_scene

        return chessboard_scene()
    if name == "flagship":
        from syzygy_tpu.assets.chess import flagship_scene

        return flagship_scene()
    if name == "sphere":
        from syzygy_tpu.assets import (
            TextureLibrary,
            register_default_textures,
            sphere_mesh,
        )
        from syzygy_tpu.scene import Scene, TransformHost

        library = TextureLibrary()
        material = register_default_textures(library)
        scene = Scene()
        scene.add_mesh_instance(
            sphere_mesh(material),
            "Sphere",
            [TransformHost.make((0.0, -8.0, 0.0), scale=(5.0, 5.0, 5.0))],
        )
        return scene, library
    if name == "dense":
        from syzygy_tpu.assets import (
            TextureLibrary,
            register_default_textures,
            sphere_mesh,
        )
        from syzygy_tpu.scene import Scene, TransformHost

        library = TextureLibrary()
        material = register_default_textures(library)
        scene = Scene()
        side = 8
        scene.add_mesh_instance(
            sphere_mesh(material, rings=32, segments=64),
            "spheres",
            [
                TransformHost.make(
                    (
                        8.0 * (i % side) - 4.0 * side,
                        -6.0,
                        8.0 * (i // side) - 4.0 * side,
                    )
                )
                for i in range(side * side)
            ],
        )
        return scene, library
    raise KeyError(f"no builtin scene named {name!r}")


# Fixed benchmark views: (eye, target) per builtin scene.
_VIEWS = {
    "flagship": ((13.0, -8.0, -14.0), (0.0, -1.0, 0.0)),
}
_DEFAULT_VIEW = ((18.0, -16.0, -22.0), (0.0, -6.0, 0.0))


def framed_scene(name: str):
    """A builtin scene with its fixed benchmark camera and the sun frozen
    at morning (time 0.35), ticked once -> (scene, library). Used by
    ``bench.py``, ``chip_smoke.py`` and the tests, so every caller renders
    the same frame."""
    import numpy as np

    from syzygy_tpu.math.geometry import eulers_from_forward

    scene, library = builtin_scene(name)
    if name != "flagship":
        scene.sun_animation.time = 0.35
        scene.sun_animation.frozen = True
    scene.tick(0.0)
    eye, target = (np.array(v, np.float32) for v in _VIEWS.get(name, _DEFAULT_VIEW))
    scene.camera.position = tuple(eye)
    scene.camera.euler_angles = tuple(
        np.asarray(eulers_from_forward(target - eye))
    )
    return scene, library


def parity_1080p_config():
    """The RenderConfig of the 1080p flagship golden
    (``tests/goldens/flagship_1080p.npz``, rendered on the CPU by
    ``tools/regen_goldens.py``): the quirk-exact paths, with the
    documented fast approximations (aerial froxel LUT, fast reflection)
    off, so a device render measures agreement on the reference math."""
    from syzygy_tpu.renderer import RenderConfig

    return RenderConfig(
        width=1920,
        height=1080,
        n_shadow_maps=4,
        aerial_lut=False,
        fast_sky_reflection=False,
    )

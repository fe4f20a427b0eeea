"""glTF 2.0 / GLB loader (pure Python; plays fastgltf + stb's role).

Port of the reference asset path (``assets/assets.cpp``):
* ``loadGLTFFromPath`` (``:1192-1283``) — parse, upload materials, load meshes
* texture source resolution (``:434-468``) and channel-override ORM synthesis
  (``:550-572, 763-790``): the roughnessMetallic texture becomes the ORM map
  with its red (occlusion) channel saturated to 255; an occlusion-only
  material zeroes green/blue instead
* color maps decode as sRGB, normal/ORM as linear UNORM (``:701-711``)
* mesh primitives -> indices/POSITION/NORMAL/TEXCOORD_0/COLOR_0 with the
  engine's **Y-flip** on positions and normals (``:1052-1060``)

Beyond the reference (which loads meshes as library assets and leaves
instancing to the editor), :func:`load_gltf_scene` also walks the node
hierarchy and instantiates every mesh node with its world TRS, so a .glb
renders as authored.
"""

from __future__ import annotations

import base64
import json
import logging
import os
import struct

import numpy as np

_log = logging.getLogger("syzygy")

# The reference parses with a default fastgltf::Parser{} (assets.cpp:421,
# no extensions registered), which REFUSES any file whose
# `extensionsRequired` names an extension the parser doesn't implement
# (fastgltf Error::MissingExtensions). Mirror that: extensionsUsed is
# informational and ignored; extensionsRequired must be a subset of what
# this loader actually understands (currently: nothing — base glTF 2.0
# only). See docs/PARITY.md "glTF support matrix".
_SUPPORTED_REQUIRED_EXTENSIONS: frozenset[str] = frozenset()

from syzygy_tpu.assets.types import (
    GeometrySurface,
    MaterialData,
    Mesh,
    TextureLibrary,
)
from syzygy_tpu.assets.defaults import register_default_textures

_COMPONENT_DTYPES = {
    5120: np.int8,
    5121: np.uint8,
    5122: np.int16,
    5123: np.uint16,
    5125: np.uint32,
    5126: np.float32,
}
_TYPE_COUNTS = {
    "SCALAR": 1,
    "VEC2": 2,
    "VEC3": 3,
    "VEC4": 4,
    "MAT4": 16,
}


def parse_glb(data: bytes) -> tuple[dict, bytes]:
    """GLB container: 12-byte header + JSON chunk + optional BIN chunk."""
    magic, version, _length = struct.unpack_from("<III", data, 0)
    if magic != 0x46546C67:  # 'glTF'
        raise ValueError("not a GLB file")
    if version != 2:
        raise ValueError(f"unsupported GLB version {version}")
    offset = 12
    gltf_json = None
    binary = b""
    while offset < len(data):
        chunk_len, chunk_type = struct.unpack_from("<II", data, offset)
        chunk = data[offset + 8 : offset + 8 + chunk_len]
        if chunk_type == 0x4E4F534A:  # 'JSON'
            gltf_json = json.loads(chunk)
        elif chunk_type == 0x004E4942:  # 'BIN\0'
            binary = bytes(chunk)
        offset += 8 + chunk_len + (-chunk_len) % 4
    if gltf_json is None:
        raise ValueError("GLB missing JSON chunk")
    return gltf_json, binary


class GLTFFile:
    """Parsed glTF with accessor/image readers."""

    def __init__(self, gltf: dict, binary: bytes, base_dir: str):
        self.gltf = gltf
        self.binary = binary
        self.base_dir = base_dir
        self._buffer_cache: dict[int, bytes] = {}
        missing = [
            e
            for e in gltf.get("extensionsRequired", [])
            if e not in _SUPPORTED_REQUIRED_EXTENSIONS
        ]
        if missing:
            raise ValueError(
                "glTF requires unsupported extensions (fastgltf "
                f"MissingExtensions semantics, assets.cpp:421): {missing}"
            )

    @staticmethod
    def open(path: str) -> "GLTFFile":
        with open(path, "rb") as f:
            data = f.read()
        base_dir = os.path.dirname(os.path.abspath(path))
        if data[:4] == b"glTF":
            gltf, binary = parse_glb(data)
            return GLTFFile(gltf, binary, base_dir)
        return GLTFFile(json.loads(data), b"", base_dir)

    def buffer(self, index: int) -> bytes:
        if index in self._buffer_cache:
            return self._buffer_cache[index]
        buf = self.gltf["buffers"][index]
        uri = buf.get("uri")
        if uri is None:
            data = self.binary
        elif uri.startswith("data:"):
            data = base64.b64decode(uri.split(",", 1)[1])
        else:
            with open(os.path.join(self.base_dir, uri), "rb") as f:
                data = f.read()
        self._buffer_cache[index] = data
        return data

    def _read_view(
        self,
        view_index: int,
        byte_offset: int,
        count: int,
        n_comp: int,
        dtype,
    ) -> np.ndarray:
        """Dense (possibly interleaved/strided) bufferView read."""
        itemsize = np.dtype(dtype).itemsize * n_comp
        view = self.gltf["bufferViews"][view_index]
        data = self.buffer(view["buffer"])
        start = view.get("byteOffset", 0) + byte_offset
        stride = view.get("byteStride", itemsize)
        if stride == itemsize:
            arr = np.frombuffer(
                data, dtype, count=count * n_comp, offset=start
            ).reshape(count, n_comp)
        else:
            rows = np.frombuffer(
                data, np.uint8, count=(count - 1) * stride + itemsize, offset=start
            )
            strided = np.lib.stride_tricks.as_strided(
                rows, (count, itemsize), (stride, 1)
            )
            arr = strided.copy().view(dtype).reshape(count, n_comp)
        return np.array(arr)

    def accessor(self, index: int) -> np.ndarray:
        """Read an accessor the way fastgltf's getAccessorElement does
        (``assets.cpp:887-1091`` reads every attribute through it):

        * missing ``bufferView`` -> zeros (spec: sparse base or all-zero)
        * ``sparse`` substitution applied on top of the base array
        * ``normalized`` integer accessors convert to f32 in [0, 1] /
          [-1, 1] (unsigned: v / max; signed: max(v / max, -1), glTF spec
          table) — raw integers would silently corrupt u8/u16 UV and color
          attributes, common in Khronos sample assets.
        """
        acc = self.gltf["accessors"][index]
        count = acc["count"]
        n_comp = _TYPE_COUNTS[acc["type"]]
        dtype = _COMPONENT_DTYPES[acc["componentType"]]
        if "bufferView" not in acc:
            arr = np.zeros((count, n_comp), dtype)
        else:
            arr = self._read_view(
                acc["bufferView"], acc.get("byteOffset", 0), count, n_comp, dtype
            )
        sparse = acc.get("sparse")
        if sparse:
            arr = arr.copy()
            s_count = sparse["count"]
            s_idx_spec = sparse["indices"]
            s_idx = self._read_view(
                s_idx_spec["bufferView"],
                s_idx_spec.get("byteOffset", 0),
                s_count,
                1,
                _COMPONENT_DTYPES[s_idx_spec["componentType"]],
            ).reshape(-1).astype(np.int64)
            s_val_spec = sparse["values"]
            s_val = self._read_view(
                s_val_spec["bufferView"],
                s_val_spec.get("byteOffset", 0),
                s_count,
                n_comp,
                dtype,
            )
            arr[s_idx] = s_val
        if acc.get("normalized") and np.issubdtype(np.dtype(dtype), np.integer):
            info = np.iinfo(dtype)
            arr = arr.astype(np.float32) / np.float32(info.max)
            if info.min < 0:
                arr = np.maximum(arr, -1.0)
        return arr

    def image_rgba(self, image_index: int) -> np.ndarray:
        """Decode an image entry to (H, W, 4) uint8 (stb_image's role).
        PNGs decode with the built-in codec; other formats need Pillow
        (``utils.png.decode_image``)."""
        from syzygy_tpu.utils.png import decode_image

        img = self.gltf["images"][image_index]
        if "uri" in img:
            uri = img["uri"]
            if uri.startswith("data:"):
                raw = base64.b64decode(uri.split(",", 1)[1])
            else:
                with open(os.path.join(self.base_dir, uri), "rb") as f:
                    raw = f.read()
        else:
            view = self.gltf["bufferViews"][img["bufferView"]]
            data = self.buffer(view["buffer"])
            start = view.get("byteOffset", 0)
            raw = bytes(data[start : start + view["byteLength"]])
        return decode_image(raw)


def _texture_image_index(gltf: dict, texture_index: int) -> int | None:
    """texture -> image indirection (``assets.cpp:434-468``)."""
    textures = gltf.get("textures", [])
    if texture_index >= len(textures):
        return None
    return textures[texture_index].get("source")


def _load_materials(
    f: GLTFFile, library: TextureLibrary, fallback: MaterialData, name_prefix: str
) -> list[MaterialData]:
    """``uploadMaterialDataAsAssets`` (``assets.cpp:735-879``)."""

    def tex_index(info: dict, mi: int, what: str) -> int | None:
        idx = info.get("index")
        if idx is not None and info.get("texCoord", 0) != 0:
            _log.warning(
                "material %d %s uses TEXCOORD_%d; only UV set 0 is loaded, "
                "sampling with TEXCOORD_0",
                mi,
                what,
                info.get("texCoord"),
            )
        return idx

    materials = []
    for mi, mat in enumerate(f.gltf.get("materials", [])):
        data = fallback
        pbr = mat.get("pbrMetallicRoughness", {})

        rm_tex = tex_index(
            pbr.get("metallicRoughnessTexture", {}), mi, "metallicRoughness"
        )
        occ_tex = tex_index(mat.get("occlusionTexture", {}), mi, "occlusion")
        orm_id = fallback.orm
        src_tex = rm_tex if rm_tex is not None else occ_tex
        if src_tex is not None:
            image_index = _texture_image_index(f.gltf, src_tex)
            if image_index is not None:
                rgba = f.image_rgba(image_index).copy()
                if rm_tex is not None:
                    rgba[..., 0] = 255  # saturate occlusion (assets.cpp:781)
                else:
                    rgba[..., 1] = 0
                    rgba[..., 2] = 0
                orm_id = library.register(
                    f"{name_prefix}_orm_{src_tex}_{rm_tex is not None}",
                    rgba,
                    srgb=False,
                )

        color_id = fallback.color
        color_tex = tex_index(pbr.get("baseColorTexture", {}), mi, "baseColor")
        if color_tex is not None:
            image_index = _texture_image_index(f.gltf, color_tex)
            if image_index is not None:
                color_id = library.register(
                    f"{name_prefix}_color_{color_tex}",
                    f.image_rgba(image_index),
                    srgb=True,
                )

        normal_id = fallback.normal
        normal_tex = tex_index(mat.get("normalTexture", {}), mi, "normal")
        if normal_tex is not None:
            image_index = _texture_image_index(f.gltf, normal_tex)
            if image_index is not None:
                normal_id = library.register(
                    f"{name_prefix}_normal_{normal_tex}",
                    f.image_rgba(image_index),
                    srgb=False,
                )

        materials.append(
            MaterialData(color=color_id, normal=normal_id, orm=orm_id)
        )
    return materials


def _load_meshes(
    f: GLTFFile, materials: list[MaterialData], fallback: MaterialData
) -> list[Mesh]:
    """``loadMeshes`` (``assets.cpp:887-1091``): primitives -> surfaces,
    Y-flip on positions and normals."""
    meshes = []
    for mesh_idx, gmesh in enumerate(f.gltf.get("meshes", [])):
        positions, normals, uvs, colors, tris = [], [], [], [], []
        surfaces = []
        vert_base = 0
        tri_base = 0
        for prim in gmesh.get("primitives", []):
            attrs = prim.get("attributes", {})
            # fastgltf-parity primitive gating (assets.cpp:905-933):
            # non-indexed / position-less primitives WARN and skip;
            # non-Triangles modes WARN and load as triangles anyway
            if "indices" not in prim:
                _log.warning(
                    "glTF mesh primitive had no valid indices accessor. "
                    "It will be skipped."
                )
                continue
            if "POSITION" not in attrs:
                _log.warning(
                    "glTF mesh primitive had no valid vertices accessor. "
                    "It will be skipped."
                )
                continue
            if prim.get("mode", 4) != 4:
                _log.warning(
                    "Loading glTF mesh primitive as Triangles mode when "
                    "it is not."
                )
            # TANGENT / TEXCOORD_1+ / skinning attributes are intentionally
            # ignored: normal mapping derives the tangent frame per pixel
            # (kernels.resolve._cotangent_frame_normal, offscreen.frag:25-43)
            # and only UV set 0 is sampled — see docs/PARITY.md matrix.
            pos = f.accessor(attrs["POSITION"]).astype(np.float32)
            n = pos.shape[0]
            nrm = (
                f.accessor(attrs["NORMAL"]).astype(np.float32)
                if "NORMAL" in attrs
                else np.tile(np.array([[0, 0, 1]], np.float32), (n, 1))
            )
            uv = (
                f.accessor(attrs["TEXCOORD_0"]).astype(np.float32)
                if "TEXCOORD_0" in attrs
                else np.zeros((n, 2), np.float32)
            )
            if "COLOR_0" in attrs:
                col = f.accessor(attrs["COLOR_0"]).astype(np.float32)
                if col.shape[1] == 3:
                    col = np.concatenate(
                        [col, np.ones((n, 1), np.float32)], axis=1
                    )
            else:
                col = np.ones((n, 4), np.float32)

            idx = f.accessor(prim["indices"]).astype(np.int64).reshape(-1)
            if idx.size % 3:  # non-Triangles modes may not divide by 3
                idx = idx[: idx.size - idx.size % 3]
            prim_tris = idx.reshape(-1, 3).astype(np.int32) + vert_base

            mat_index = prim.get("material")
            material = (
                materials[mat_index]
                if mat_index is not None and mat_index < len(materials)
                else fallback
            )
            surfaces.append(
                GeometrySurface(
                    first_tri=tri_base,
                    tri_count=len(prim_tris),
                    material=material,
                )
            )
            positions.append(pos)
            normals.append(nrm)
            uvs.append(uv)
            colors.append(col)
            tris.append(prim_tris)
            vert_base += n
            tri_base += len(prim_tris)

        if not surfaces:
            continue
        pos = np.concatenate(positions)
        nrm = np.concatenate(normals)
        # FLIP_Y (assets.cpp:1052-1060)
        pos[:, 1] *= -1
        nrm[:, 1] *= -1
        meshes.append(
            Mesh(
                pos,
                nrm,
                np.concatenate(uvs),
                np.concatenate(colors),
                np.concatenate(tris),
                surfaces,
                gmesh.get("name", f"mesh_{mesh_idx}"),
            )
        )
    return meshes


def _node_matrix(node: dict) -> np.ndarray:
    if "matrix" in node:
        return np.asarray(node["matrix"], np.float32).reshape(4, 4).T
    m = np.eye(4, dtype=np.float32)
    t = node.get("translation", [0, 0, 0])
    q = node.get("rotation", [0, 0, 0, 1])  # xyzw
    s = node.get("scale", [1, 1, 1])
    x, y, z, w = q
    rot = np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ],
        np.float32,
    )
    m[:3, :3] = rot * np.asarray(s, np.float32)[None, :]
    m[:3, 3] = t
    return m


_FLIP_Y = np.diag(np.array([1.0, -1.0, 1.0, 1.0], np.float32))


def load_gltf_meshes(
    path: str, library: TextureLibrary | None = None
) -> tuple[list[Mesh], TextureLibrary]:
    """``loadGLTFFromPath`` (``assets.cpp:1192-1283``): meshes + textures."""
    library = library or TextureLibrary()
    fallback = register_default_textures(library)
    f = GLTFFile.open(path)
    prefix = os.path.splitext(os.path.basename(path))[0]
    materials = _load_materials(f, library, fallback, prefix)
    meshes = _load_meshes(f, materials, fallback)
    return meshes, library


def load_gltf_scene(path: str, library: TextureLibrary | None = None):
    """Load a .glb/.gltf as a renderable Scene: one instance per mesh node
    with its world transform (decomposition-free: the instance carries the
    baked matrix via per-node pseudo TRS)."""
    from syzygy_tpu.scene.scene import Scene, TransformHost

    library = library or TextureLibrary()
    fallback = register_default_textures(library)
    f = GLTFFile.open(path)
    prefix = os.path.splitext(os.path.basename(path))[0]
    materials = _load_materials(f, library, fallback, prefix)
    meshes = _load_meshes(f, materials, fallback)

    # map glTF mesh index -> loaded Mesh (some may be skipped)
    mesh_by_index: dict[int, Mesh] = {}
    li = 0
    for mi, gmesh in enumerate(f.gltf.get("meshes", [])):
        # must mirror _load_meshes' skip logic (non-Triangles modes load)
        has_tris = any(
            "POSITION" in p.get("attributes", {}) and "indices" in p
            for p in gmesh.get("primitives", [])
        )
        if has_tris and li < len(meshes):
            mesh_by_index[mi] = meshes[li]
            li += 1

    scene = Scene()
    nodes = f.gltf.get("nodes", [])
    scenes = f.gltf.get("scenes", [])
    scene_index = f.gltf.get("scene", 0)
    roots = scenes[scene_index]["nodes"] if scenes else range(len(nodes))

    instances: dict[int, list[np.ndarray]] = {}

    def walk(node_index: int, parent: np.ndarray):
        node = nodes[node_index]
        world = parent @ _node_matrix(node)
        if "mesh" in node and node["mesh"] in mesh_by_index:
            instances.setdefault(node["mesh"], []).append(world)
        for child in node.get("children", []):
            walk(child, world)

    for root in roots:
        walk(root, np.eye(4, dtype=np.float32))

    for mesh_index, mats in instances.items():
        mesh = mesh_by_index[mesh_index]
        # Bake each node's world matrix into a dedicated mesh copy when the
        # transform has rotation (TransformHost is TRS-only); pure TRS-like
        # matrices decompose exactly.
        transforms = []
        baked_meshes = []
        for m in mats:
            # glTF is +y up; the engine flips y. Conjugate the node matrix so
            # the already-flipped mesh lands where the authored scene puts it.
            m_eng = _FLIP_Y @ m @ _FLIP_Y
            baked = Mesh(
                positions=(m_eng[:3, :3] @ mesh.positions.T).T + m_eng[:3, 3],
                normals=(
                    np.linalg.inv(m_eng[:3, :3]).T @ mesh.normals.T
                ).T.astype(np.float32),
                uvs=mesh.uvs,
                colors=mesh.colors,
                triangles=mesh.triangles,
                surfaces=mesh.surfaces,
                name=mesh.name,
            )
            norms = np.linalg.norm(baked.normals, axis=1, keepdims=True)
            baked.normals = (baked.normals / np.maximum(norms, 1e-12)).astype(
                np.float32
            )
            baked_meshes.append(baked)
            transforms.append(TransformHost.make())
        for i, (baked, t) in enumerate(zip(baked_meshes, transforms)):
            inst = scene.add_mesh_instance(
                baked, f"{prefix}_{mesh.name}_{i}", [t]
            )
            # node transforms are pre-baked; undo setMesh's scale
            # normalization so authored sizes are preserved (in-place:
            # transform rows are views into the instance's SoA blocks)
            inst.scales[:] = 1.0
    return scene, library

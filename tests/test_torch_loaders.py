"""The port's mesh and image loaders against the JAX package's, on files
each test writes: OBJ (quads, polygons, negative indices, missing
normals), PLY (ascii, binary of both endiannesses, faces of mixed
lengths), glTF (GLB and ``.gltf`` with a data URI: TRS node trees,
KHR_texture_transform, transmission and volume, a second UV set, the
alpha modes, a camera node, strided and normalized accessors), the
tangent generators (MikkTSpace and the fallback), the PNG decoder
(colour types 0, 2, 3, 4 and 6 with every filter, against Pillow, which
the JAX package decodes with), the texture atlas of images whose sides
are not powers of two (Pillow's bilinear resize in the JAX package), and
a ``.scene`` file of ``mesh`` records whose ``SceneArrays`` match.
Meshes, materials and images must be bit-equal. No JAX jit: the JAX
side is numpy.
"""

import base64
import dataclasses
import io
import json
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from metal_pathtracer_tpu.ops.textures import (
    build_texture_arrays as jax_atlas,
)
from metal_pathtracer_tpu.scene import dsl as jax_dsl
from metal_pathtracer_tpu.scene import gltf as jax_gltf
from metal_pathtracer_tpu.scene import obj as jax_obj
from metal_pathtracer_tpu.scene import ply as jax_ply
from metal_pathtracer_tpu.scene import tangent as jax_tangent
from metal_pathtracer_tpu.scene.meshload import mesh_loader as jax_loader
from metal_pathtracer_tpu.scene.resources import SceneResources as JResources
from metal_pathtracer_tpu.settings import RenderSettings as JSettings
from metal_pathtracer_tpu_torch.ops.textures import (
    build_texture_arrays,
    resize_rgba_bilinear,
)
from metal_pathtracer_tpu_torch.scene import dsl, gltf, obj, ply, tangent
from metal_pathtracer_tpu_torch.scene.resources import Mesh, SceneResources
from metal_pathtracer_tpu_torch.settings import RenderSettings
from metal_pathtracer_tpu_torch.utils import meshfiles
from metal_pathtracer_tpu_torch.utils.image_io import (
    ImageFormatError,
    decode_png,
    encode_png_u8,
)
from metal_pathtracer_tpu_torch.utils.procgen import icosphere

# ---- helpers ----------------------------------------------------------------

_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else b if pb <= pc else c


def png(px, ctype, filters=(0, 1, 2, 3, 4), plte=None, trns=None,
        depth=8, interlace=0):
    """PNG bytes of (H, W, C) uint8 samples of colour type ``ctype``, row
    y filtered with ``filters[y % len(filters)]``."""
    h, w, ch = px.shape
    rows = px.reshape(h, w * ch).astype(int)
    raw = bytearray()
    for y in range(h):
        f = filters[y % len(filters)]
        prior = rows[y - 1] if y else np.zeros(w * ch, int)
        raw.append(f)
        for i in range(w * ch):
            a = rows[y, i - ch] if i >= ch else 0
            b, c = prior[i], (prior[i - ch] if i >= ch else 0)
            pred = (0, a, b, (a + b) >> 1, _paeth(a, b, c))[f]
            raw.append((rows[y, i] - pred) & 255)

    def chunk(tag, body):
        return struct.pack(">I", len(body)) + tag + body \
            + struct.pack(">I", zlib.crc32(tag + body))

    out = b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, ctype, 0, 0, interlace))
    if plte is not None:
        out += chunk(b"PLTE", plte.tobytes())
    if trns is not None:
        out += chunk(b"tRNS", trns)
    return out + chunk(b"IDAT", zlib.compress(bytes(raw))) \
        + chunk(b"IEND", b"")


def _pil_rgba(data):
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"),
                      np.uint8)


def _assert_meshes_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.name == b.name and a.material == b.material
        for f in ("vertices", "normals", "uv0", "uv1", "tangents",
                  "indices"):
            x, y = getattr(a, f), getattr(b, f)
            assert x.dtype == y.dtype, f
            np.testing.assert_array_equal(x, y, err_msg=f)


def _assert_materials_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        da, db = dataclasses.asdict(a), dataclasses.asdict(b)
        ta, tb = da.pop("texture_transform"), db.pop("texture_transform")
        assert da == db
        np.testing.assert_array_equal(ta, tb)


def _assert_resources_equal(pr, jr):
    _assert_meshes_equal(pr.meshes, jr.meshes)
    _assert_materials_equal(pr.materials, jr.materials)
    assert pr.texture_srgb == jr.texture_srgb
    assert pr.texture_wrap == jr.texture_wrap
    assert len(pr.texture_images) == len(jr.texture_images)
    for a, b in zip(pr.texture_images, jr.texture_images):
        assert a.dtype == b.dtype == np.uint8
        np.testing.assert_array_equal(a, b)


def _raw_equal(got, want):
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


_TF = np.array([[0.0, -2.0, 0.0, 0.5], [1.5, 0.0, 0.0, -1.0],
                [0.0, 0.0, 0.75, 2.0], [0.0, 0.0, 0.0, 1.0]])

# ---- OBJ ----------------------------------------------------------------------

_OBJ = """\
# quads, a pentagon, negative indices and a face without normals
v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0
v 0.1 0.2 1.3333333333333333
v -0.7 0.30000000000000004 1e-3
v 2.5 -1.25 0.1
vt 0 0
vt 1 0
vt 1 1
vt 0.5 0.25
vn 0 0 1
vn 0.6 0.8 0
f 1/1/1 2/2/1 3/3/1 4/4/1
f -3/-1/-1 -2/-2/-2 -1/-3/-1 1/1/1 2/2/2
f 5 6 7
f 1//2 3//2 5//1
f 2/4 4/1 6/2
"""


def test_obj_matches_jax(tmp_path):
    path = tmp_path / "faces.obj"
    path.write_text(_OBJ)
    _raw_equal(obj.load_obj_raw(str(path)), jax_obj.load_obj_raw(str(path)))
    pos, nrm, uv, idx = obj.load_obj_raw(str(path))
    assert idx.shape == (2 + 3 + 1 + 1 + 1, 3)
    # the face without normals took its flat normal
    assert np.abs(np.linalg.norm(nrm[idx[5]], axis=-1) - 1.0).max() < 1e-6
    _assert_meshes_equal([obj.load_obj(str(path), "m", 2, _TF)],
                         [jax_obj.load_obj(str(path), "m", 2, _TF)])


def test_obj_writer_roundtrip(tmp_path):
    """``meshfiles.write_obj`` keeps every float32 through the loader's
    double-then-float32 read."""
    verts, faces = icosphere(2)
    rng = np.random.default_rng(5)
    mesh = Mesh("s", (verts * 0.37 + 1.1).astype(np.float32),
                verts.astype(np.float32),
                rng.random((len(verts), 2)).astype(np.float32),
                np.zeros((len(verts), 2), np.float32),
                np.zeros((len(verts), 4), np.float32),
                faces.astype(np.int32))
    path = str(tmp_path / "s.obj")
    meshfiles.write_obj(path, mesh)
    pos, nrm, uv, idx = obj.load_obj_raw(path)
    for got, want in ((pos, mesh.vertices), (nrm, mesh.normals),
                      (uv, mesh.uv0)):
        np.testing.assert_array_equal(got[idx], want[mesh.indices])
    _raw_equal((pos, nrm, uv, idx), jax_obj.load_obj_raw(path))


# ---- PLY ----------------------------------------------------------------------

def _ply_file(path, fmt, faces, normals=True, extra=True):
    """A PLY of 6 vertices (double x y z, float normals, uchar s t) and
    ``faces``, with an extra element carrying a list after the faces."""
    rng = np.random.default_rng(9)
    xyz = rng.normal(size=(6, 3))
    nrm = rng.normal(size=(6, 3)).astype(np.float32)
    st = rng.integers(0, 255, (6, 2))
    head = ["ply", f"format {fmt} 1.0", "comment test", "element vertex 6",
            "property double x", "property double y", "property double z"]
    if normals:
        head += ["property float nx", "property float ny",
                 "property float nz"]
    head += ["property uchar s", "property uchar t",
             f"element face {len(faces)}", "property uchar flags",
             "property list uchar int vertex_indices"]
    if extra:
        head += ["element edge 2", "property list ushort short pair",
                 "property float weight"]
    head.append("end_header")
    body = b""
    if fmt == "ascii":
        rows = []
        for k in range(6):
            vals = [repr(float(v)) for v in xyz[k]]
            if normals:
                vals += [repr(float(v)) for v in nrm[k]]
            rows.append(" ".join(vals + [str(int(v)) for v in st[k]]))
        rows += [f"7 {len(f)} " + " ".join(map(str, f)) for f in faces]
        if extra:
            rows += ["2 0 1 0.5", "2 2 3 0.25"]
        body = ("\n".join(rows) + "\n").encode()
    else:
        e = "<" if "little" in fmt else ">"
        for k in range(6):
            body += struct.pack(e + "3d", *xyz[k])
            if normals:
                body += struct.pack(e + "3f", *nrm[k])
            body += struct.pack(e + "2B", *st[k])
        for f in faces:
            body += struct.pack(e + "BB", 7, len(f)) \
                + struct.pack(e + f"{len(f)}i", *f)
        if extra:
            body += struct.pack(e + "H2hf", 2, 0, 1, 0.5) \
                + struct.pack(e + "H2hf", 2, 2, 3, 0.25)
    path.write_bytes(("\n".join(head) + "\n").encode() + body)


@pytest.mark.parametrize("fmt", ["ascii", "binary_little_endian",
                                 "binary_big_endian"])
@pytest.mark.parametrize("faces", ["mixed", "quads"])
def test_ply_matches_jax(tmp_path, fmt, faces):
    lists = [[0, 1, 2], [0, 2, 3, 4], [1, 2, 3, 4, 5], [5, 4, 3]] \
        if faces == "mixed" else [[0, 1, 2, 3], [2, 3, 4, 5], [5, 4, 1, 0]]
    for normals in (True, False):
        path = tmp_path / f"m{normals}.ply"
        _ply_file(path, fmt, lists, normals)
        _raw_equal(ply.load_ply_raw(str(path)),
                   jax_ply.load_ply_raw(str(path)))
        _assert_meshes_equal([ply.load_ply(str(path), "p", 1, _TF)],
                             [jax_ply.load_ply(str(path), "p", 1, _TF)])


def test_ply_writer_roundtrip(tmp_path):
    verts, faces = icosphere(3)
    mesh = Mesh("d", (verts * 1.7).astype(np.float32),
                verts.astype(np.float32),
                (verts[:, :2] * 0.5 + 0.5).astype(np.float32),
                np.zeros((len(verts), 2), np.float32),
                np.zeros((len(verts), 4), np.float32),
                faces.astype(np.int32))
    for fmt in ("ascii", "binary_little_endian", "binary_big_endian"):
        path = str(tmp_path / f"{fmt}.ply")
        meshfiles.write_ply(path, mesh, fmt)
        got = ply.load_ply_raw(path)
        for a, b in zip(got, (mesh.vertices, mesh.normals, mesh.uv0,
                              mesh.indices)):
            np.testing.assert_array_equal(a, b)
        _raw_equal(got, jax_ply.load_ply_raw(path))


# ---- glTF ---------------------------------------------------------------------

def _prim_meshes():
    """Two small meshes: a UV sphere part with a second UV set, and a quad
    without normals."""
    verts, faces = icosphere(1)
    uv = np.stack([0.5 + np.arctan2(verts[:, 2], verts[:, 0]) / (2 * np.pi),
                   0.5 - np.arcsin(np.clip(verts[:, 1], -1, 1)) / np.pi],
                  -1).astype(np.float32)
    ball = Mesh("ball", verts.astype(np.float32), verts.astype(np.float32),
                uv, (uv * 2.0).astype(np.float32),
                np.zeros((len(verts), 4), np.float32),
                faces.astype(np.int32), material=0)
    quad = Mesh("quad", np.array([[-1, 0, -1], [1, 0, -1], [1, 0, 1],
                                  [-1, 0, 1]], np.float32),
                np.zeros((4, 3), np.float32),
                np.array([[0, 0], [3, 0], [3, 3], [0, 3]], np.float32),
                np.zeros((4, 2), np.float32), np.zeros((4, 4), np.float32),
                np.array([[0, 2, 1], [0, 3, 2]], np.int32), material=1)
    return [ball, quad]


def _gltf_doc():
    rng = np.random.default_rng(2)
    images = [png(rng.integers(0, 256, (16, 16, 4), dtype=np.uint8), 6),
              encode_png_u8(rng.integers(0, 256, (12, 20, 3),
                                         dtype=np.uint8)),
              png(rng.integers(0, 256, (8, 8, 1), dtype=np.uint8), 0)]
    materials = [
        {"name": "coat", "pbrMetallicRoughness": {
            "baseColorFactor": [0.9, 0.5, 0.25, 0.5],
            "metallicFactor": 0.25, "roughnessFactor": 0.625,
            "baseColorTexture": {"index": 0, "extensions": {
                "KHR_texture_transform": {"offset": [0.25, 0.5],
                                          "rotation": 0.3,
                                          "scale": [2.0, 0.5]}}},
            "metallicRoughnessTexture": {"index": 1, "texCoord": 1}},
         "normalTexture": {"index": 2, "scale": 0.75},
         "occlusionTexture": {"index": 2, "strength": 0.5},
         "emissiveTexture": {"index": 0},
         "emissiveFactor": [1.0, 0.5, 0.25],
         "alphaMode": "BLEND", "doubleSided": True,
         "extensions": {"KHR_materials_emissive_strength":
                        {"emissiveStrength": 3.0}}},
        {"pbrMetallicRoughness": {"roughnessFactor": 0.5},
         "alphaMode": "MASK", "alphaCutoff": 0.3,
         "extensions": {
             "KHR_materials_transmission": {
                 "transmissionFactor": 0.8,
                 "transmissionTexture": {"index": 1}},
             "KHR_materials_volume": {
                 "thicknessFactor": 0.2, "attenuationDistance": 0.5,
                 "attenuationColor": [0.9, 0.5, 0.0001]},
             "KHR_materials_ior": {"ior": 1.33}}},
    ]
    meshes = _prim_meshes()
    nodes = [
        {"name": "root", "translation": [0.5, -1.0, 2.0],
         "rotation": [0.0, 0.38268343, 0.0, 0.92387953],
         "scale": [1.5, 1.5, 0.5], "children": [1, 2]},
        {"name": "ball", "mesh": 0, "translation": [0.0, 1.0, 0.0]},
        {"name": "floor", "mesh": 1, "matrix": [
            2, 0, 0, 0, 0, 1, 0, 0, 0, 0, 2, 0, 0, -0.5, 0, 1]},
        {"name": "cam", "camera": 0, "translation": [0.0, 1.0, 6.0]},
    ]
    doc, data = meshfiles.gltf_document(meshes, materials, images, nodes)
    doc["cameras"] = [{"type": "perspective",
                       "perspective": {"yfov": 0.6, "znear": 0.1}}]
    doc["samplers"] = [{"wrapS": 33071, "wrapT": 33648}, {}]
    doc["textures"][1]["sampler"] = 1
    return doc, data


def _load_pair(path, settings_edit=None):
    ps, pr, js, jr = RenderSettings(), SceneResources(), JSettings(), \
        JResources()
    if settings_edit is not None:
        settings_edit(ps)
        settings_edit(js)
    gltf.load_gltf_into(str(path), ps, pr, _TF, allow_camera_import=True)
    jax_gltf.load_gltf_into(str(path), js, jr, _TF, allow_camera_import=True)
    return ps, pr, js, jr


def _assert_camera_equal(ps, js):
    for key in ("cameraTarget", "cameraDistance", "cameraYaw",
                "cameraPitch", "cameraVerticalFov"):
        assert getattr(ps, key) == getattr(js, key), key


@pytest.mark.parametrize("container", ["glb", "gltf_data_uri"])
def test_gltf_matches_jax(tmp_path, container):
    doc, data = _gltf_doc()
    if container == "glb":
        path = tmp_path / "scene.glb"
        path.write_bytes(meshfiles.glb_bytes(doc, data))
    else:
        doc["buffers"][0]["uri"] = ("data:application/octet-stream;base64,"
                                    + base64.b64encode(data).decode())
        path = tmp_path / "scene.gltf"
        path.write_text(json.dumps(doc))
    ps, pr, js, jr = _load_pair(path)
    _assert_resources_equal(pr, jr)
    _assert_camera_equal(ps, js)
    assert len(pr.meshes) == 2 and len(pr.texture_images) == 3
    assert pr.texture_wrap[0] == (1, 2)
    assert {m.pbr_alpha_mode for m in pr.materials} == {1, 2}
    # the quad had no normals: flat ones, summed per vertex
    assert np.abs(np.linalg.norm(pr.meshes[1].normals, axis=-1)
                  - 1.0).max() < 1e-6


def test_gltf_settings_and_accessors(tmp_path):
    """The ``gltf*`` settings, and accessors that are strided (an
    interleaved view), normalized integers (uint8 UVs, int16 normals),
    sparse, and without a buffer view."""
    doc, data = _gltf_doc()
    ball = doc["meshes"][0]["primitives"][0]["attributes"]
    n = doc["accessors"][ball["POSITION"]]["count"]
    rng = np.random.default_rng(8)
    uv8 = rng.integers(0, 256, (n, 2), dtype=np.uint8)
    nrm16 = rng.integers(-32768, 32767, (n, 3), dtype=np.int16)
    inter = np.zeros(n, np.dtype([("uv", "u1", (2,)), ("pad", "u1", (2,)),
                                  ("n", "<i2", (3,)), ("pad2", "u1", (2,))]))
    inter["uv"], inter["n"] = uv8, nrm16
    data = data + b"\0" * (-len(data) % 4)
    start = len(data)
    sparse_idx = np.array([1, 4], np.uint16)
    sparse_val = np.array([[0.5, 0.5, 0.5, 1], [1, 2, 3, -1]], np.float32)
    data += inter.tobytes() + sparse_idx.tobytes() + sparse_val.tobytes()
    views = doc["bufferViews"]
    k = len(views)
    views += [{"buffer": 0, "byteOffset": start, "byteStride": 12,
               "byteLength": inter.nbytes},
              {"buffer": 0, "byteOffset": start + inter.nbytes,
               "byteLength": 4},
              {"buffer": 0, "byteOffset": start + inter.nbytes + 4,
               "byteLength": 32}]
    a = len(doc["accessors"])
    doc["accessors"] += [
        {"bufferView": k, "componentType": 5121, "normalized": True,
         "count": n, "type": "VEC2"},
        {"bufferView": k, "byteOffset": 4, "componentType": 5122,
         "normalized": True, "count": n, "type": "VEC3"},
        {"componentType": 5126, "count": n, "type": "VEC4", "sparse": {
            "count": 2, "indices": {"bufferView": k + 1,
                                    "componentType": 5123},
            "values": {"bufferView": k + 2}}}]
    ball["TEXCOORD_0"], ball["NORMAL"], ball["TANGENT"] = a, a + 1, a + 2
    doc["buffers"][0]["byteLength"] = len(data)
    path = tmp_path / "acc.glb"
    path.write_bytes(meshfiles.glb_bytes(doc, data))

    def edit(s):
        s.gltfEmissiveScale = 2.5
        s.gltfThinWalledFallback = False
        s.gltfCompatForceLinearBaseColor = True
        s.gltfCompatForceLinearEmissive = True

    ps, pr, js, jr = _load_pair(path, edit)
    _assert_resources_equal(pr, jr)
    got = gltf.GltfFile(str(path))
    np.testing.assert_array_equal(got.accessor(a),
                                  uv8.astype(np.float32) / 255.0)
    np.testing.assert_array_equal(got.accessor(a + 2)[[1, 4]], sparse_val)
    assert not any(pr.texture_srgb)


# ---- tangents -----------------------------------------------------------------

def test_tangents_match_jax():
    verts, faces = icosphere(2)
    uv = np.stack([0.5 + np.arctan2(verts[:, 2], verts[:, 0]) / (2 * np.pi),
                   0.5 - np.arcsin(np.clip(verts[:, 1], -1, 1)) / np.pi],
                  -1).astype(np.float32)
    pos, nrm = verts.astype(np.float32), verts.astype(np.float32)
    mikkt = tangent.generate_tangents_mikktspace(pos, nrm, uv, faces)
    assert mikkt is not None, "native/build.sh failed for libtangentgen"
    want = jax_tangent.generate_tangents_mikktspace(pos, nrm, uv, faces)
    np.testing.assert_array_equal(mikkt, want)
    np.testing.assert_array_equal(tangent.generate_tangents(pos, nrm, uv,
                                                            faces), want)
    fb = tangent.generate_tangents_fallback(pos, nrm, uv, faces)
    np.testing.assert_array_equal(
        fb, jax_tangent.generate_tangents_fallback(pos, nrm, uv, faces))
    assert not np.array_equal(fb, mikkt)
    assert set(np.unique(mikkt[:, 3])) <= {-1.0, 1.0}


# ---- PNG and the atlas --------------------------------------------------------

@pytest.mark.parametrize("ctype", [0, 2, 3, 4, 6])
def test_png_decoder_matches_pillow(ctype):
    rng = np.random.default_rng(ctype)
    cases = []
    if ctype == 3:
        px = rng.integers(0, 12, (9, 11, 1), dtype=np.uint8)
        plte = rng.integers(0, 256, (12, 3), dtype=np.uint8)
        cases += [png(px, 3, plte=plte),
                  png(px, 3, plte=plte,
                      trns=bytes(rng.integers(0, 256, 7, dtype=np.uint8)))]
    else:
        px = rng.integers(0, 256, (9, 11, _CHANNELS[ctype]), dtype=np.uint8)
        cases.append(png(px, ctype))
        if ctype in (0, 2):   # a colour key
            key = b"".join(struct.pack(">H", int(v)) for v in px[4, 5])
            cases.append(png(px, ctype, trns=key))
    for data in cases:
        got = decode_png(data)
        assert got.shape == (9, 11, 4) and got.dtype == np.uint8
        np.testing.assert_array_equal(got, _pil_rgba(data))


def test_png_decoder_refusals():
    """16-bit, interlaced and JPEG images decode since the image-format
    slice (``tests/test_torch_image_formats.py``); what ``decode_png``
    still refuses is a file that is not a valid PNG: a bit depth its
    colour type cannot have, an unknown colour type or interlace method,
    a filter type outside 0-4, or another format."""
    px = np.zeros((2, 2, 3), np.uint8)
    bad_filter = bytearray(png(px, 2, filters=(0,)))
    idat = bad_filter.index(b"IDAT") + 4
    body = zlib.compress(b"\x07" + bytes(6) + b"\x00" + bytes(6))
    bad_filter[idat - 8:] = (struct.pack(">I", len(body)) + b"IDAT" + body
                             + struct.pack(">I", zlib.crc32(b"IDAT" + body))
                             + bad_filter[-12:])
    for data, what in ((png(px, 2, depth=4), "colour type 2 at 4 bits"),
                       (png(px, 5), "colour type 5"),
                       (png(px, 2, interlace=2), "interlace method 2"),
                       (bytes(bad_filter), "filter type 7"),
                       (b"\xff\xd8\xff\xe0" + b"\0" * 16, "not a PNG")):
        with pytest.raises(ImageFormatError, match=what):
            decode_png(data)


def test_atlas_of_odd_sizes_matches_jax():
    rng = np.random.default_rng(6)
    images = [rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
              for h, w in ((37, 20), (64, 64), (3, 100), (129, 255))]
    images[0][::3, ..., 3] = 0
    srgb = [True, False, True, False]
    for size in (None, 32):
        got = build_texture_arrays(images, srgb, [(0, 1)] * 4, size=size,
                                   device="cpu")
        want = jax_atlas(images, srgb, [(0, 1)] * 4, size=size)
        for f in ("texels", "level_offset", "level_w", "level_h",
                  "n_levels", "size0", "wrap_mode"):
            np.testing.assert_array_equal(getattr(got, f).numpy(),
                                          np.asarray(getattr(want, f)),
                                          err_msg=f)
    img = images[3]
    np.testing.assert_array_equal(
        resize_rgba_bilinear(img, 77, 300),
        np.asarray(Image.fromarray(img, "RGBA").resize((77, 300),
                                                       Image.BILINEAR)))


# ---- a .scene file of mesh records --------------------------------------------

def test_mesh_records_scene_matches_jax(tmp_path):
    """A ``.scene`` file with an OBJ (scaled, rotated, by material name),
    a binary PLY (translated, by index) and a GLB (its own materials and
    textures) in a subdirectory: the resources and the ``SceneArrays``
    equal the JAX package's (its DSL with ``meshload.mesh_loader``)."""
    (tmp_path / "meshes").mkdir()
    (tmp_path / "meshes" / "faces.obj").write_text(_OBJ)
    verts, faces = icosphere(2)
    meshfiles.write_ply(str(tmp_path / "meshes" / "ball.ply"), Mesh(
        "b", verts.astype(np.float32), verts.astype(np.float32),
        np.zeros((len(verts), 2), np.float32),
        np.zeros((len(verts), 2), np.float32),
        np.zeros((len(verts), 4), np.float32), faces.astype(np.int32)))
    doc, data = _gltf_doc()
    (tmp_path / "meshes" / "set.glb").write_bytes(
        meshfiles.glb_bytes(doc, data))
    (tmp_path / "s.scene").write_text(
        "renderer maxDepth=3 seed=5\n"
        "material type=lambert albedo=0.5,0.5,0.5 name=grey\n"
        "material type=dielectric ior=1.5\n"
        "mesh path=meshes/faces.obj material=grey scale=0.5 "
        "rotate=10,20,30\n"
        "mesh file=meshes/ball.ply material=1 translate=0,1,0 "
        "name=glassball\n"
        "mesh path=meshes/set.glb scale=1,2,1\n")
    ps, pr, js, jr = RenderSettings(), SceneResources(), JSettings(), \
        JResources()
    dsl.load_scene_file(str(tmp_path / "s.scene"), ps, pr)
    jax_dsl.load_scene_file(str(tmp_path / "s.scene"), js, jr,
                            mesh_loader=jax_loader)
    _assert_resources_equal(pr, jr)
    _assert_camera_equal(ps, js)
    assert pr.meshes[1].name == "glassball"
    scene = pr.build_arrays(device="cpu")
    jscene = jr.build_arrays()
    for part in ("triangles", "materials", "tri_bvh"):
        p, j = getattr(scene, part), getattr(jscene, part)
        for f in dataclasses.fields(p):
            if f.name == "shade_packed":
                np.testing.assert_array_equal(
                    p.shade_packed.numpy()[:, :22],
                    np.asarray(j.shade_packed)[:, :22])
                continue
            got = getattr(p, f.name)
            if hasattr(got, "numpy"):
                np.testing.assert_array_equal(
                    got.numpy(), np.asarray(getattr(j, f.name)),
                    err_msg=f"{part}.{f.name}")
    for f in ("texels", "level_offset", "level_w", "level_h", "wrap_mode"):
        np.testing.assert_array_equal(getattr(scene.textures, f).numpy(),
                                      np.asarray(getattr(jscene.textures,
                                                         f)))
    # instanced PLY and OBJ placements (ported): one group per file, the
    # loaded object-space mesh shared by its records, as in the JAX package
    (tmp_path / "i.scene").write_text(
        "material type=lambert albedo=0.5,0.5,0.5\n"
        "mesh path=meshes/ball.ply instanced=1\n"
        "mesh path=meshes/faces.obj instanced=1 translate=2,0,0\n"
        "mesh path=meshes/ball.ply instanced=1 scale=0.5 rotate=0,30,0\n")
    ir, jir = SceneResources(), JResources()
    dsl.load_scene_file(str(tmp_path / "i.scene"), RenderSettings(), ir)
    jax_dsl.load_scene_file(str(tmp_path / "i.scene"), JSettings(), jir,
                            mesh_loader=jax_loader)
    assert ir.mesh_instances[0].source is ir.mesh_instances[2].source
    for got, want in zip(ir.mesh_instances, jir.mesh_instances,
                         strict=True):
        np.testing.assert_array_equal(got.transform, want.transform)
        for f in ("vertices", "normals", "uv0", "indices"):
            np.testing.assert_array_equal(getattr(got.source, f),
                                          getattr(want.source, f))
    placed, jplaced = ir.build_arrays(device="cpu"), jir.build_arrays()
    assert placed.triangles is None and jplaced.triangles is None
    assert [(g.base_id, g.count) for g in placed.instanced] == \
        [(g.base_id, g.count) for g in jplaced.instanced] == [(0, 2), (2, 1)]
    for g, jg in zip(placed.instanced, jplaced.instanced):
        for f in ("v0", "v1", "v2", "n0", "n1", "n2", "mesh_index"):
            np.testing.assert_array_equal(getattr(g.triangles, f).numpy(),
                                          np.asarray(getattr(jg.triangles,
                                                             f)))
    (tmp_path / "bad.scene").write_text("mesh path=meshes/none.obj\n")
    with pytest.raises(dsl.SceneParseError, match="not found"):
        dsl.load_scene_file(str(tmp_path / "bad.scene"), RenderSettings(),
                            SceneResources())


def test_headline_files_match_jax(tmp_path):
    """``meshfiles.write_headline_files`` (the mesh-files cell's scene:
    the headline's meshes as PLY, OBJ and GLB with an EXR sky) read by
    both packages' DSLs: equal resources and settings; the PLY and OBJ
    triangles and UVs equal the in-memory meshes', and MikkTSpace made
    the GLB meshes' tangents."""
    path, meshes = meshfiles.write_headline_files(str(tmp_path), 2, "cpu")
    ps, pr, js, jr = RenderSettings(), SceneResources(), JSettings(), \
        JResources()
    dsl.load_scene_file(path, ps, pr)
    jax_dsl.load_scene_file(path, js, jr, mesh_loader=jax_loader)
    _assert_resources_equal(pr, jr)
    assert ps.environmentMapPath == js.environmentMapPath
    assert [m.name for m in pr.meshes] == ["dragon.ply", "glass.obj",
                                           "checker-sphere", "ground"]
    for got, want in zip(pr.meshes[:2], meshes[:2]):
        for f in ("vertices", "uv0"):
            np.testing.assert_array_equal(getattr(got, f)[got.indices],
                                          getattr(want, f)[want.indices])
    for m in pr.meshes[2:]:
        np.testing.assert_array_equal(m.tangents,
                                      tangent.generate_tangents_mikktspace(
                                          m.vertices, m.normals, m.uv0,
                                          m.indices))
    assert [im.shape[:2] for im in pr.texture_images] == [(512, 512),
                                                         (120, 200)]

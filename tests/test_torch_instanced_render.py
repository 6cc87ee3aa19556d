"""Instanced scenes end to end, the port's plain path against the JAX
package's XLA render (``frame.render_samples``), each package building
the scene with its own code, at 40x24, 2 spp:

- (a) ``tests/test_instancing.py``'s blob placed three times (rotated,
  scaled by 0.8, 1 and 1.25), lambert, gradient sky, maxDepth 4: no soup
  at all (``triangles is None``), stage ``full`` over instanced hits only,
  bounces between placements (the global instance ids of the self-hit
  exclusion);
- (b) a ``.scene`` of ``mesh`` records under the 32x16 HDR environment
  with a sun block, spec-NEE on, maxDepth 4: a GLB soup (a checker-textured
  PBR sphere and a PBR ground with a metallic-roughness texture), a glass
  icosphere OBJ placed twice with ``instanced=1`` (the spec-NEE chain
  through a dielectric instance) and a displaced icosphere PLY placed
  twice with the checker's textured PBR material: the XLA reference
  textures such a lane with the SOUP's UVs, tangents and Igehy triangle
  at ``clip(object triangle, 0, soup count - 1)`` (``ops/pbr_textures.py
  :177-211``; ROADMAP Queue 3), and so does the port.

The gate is the ladder's tight image gate: RMSE < 2e-4, more than 98 % of
pixels within 1e-5, ray and shadow counts within max(4, 1e-4 * rays).
One JAX render per scene; ~40 s. The pixel probe on a placement reports
the global instance id (port only).
"""

import math
import os
import sys

import numpy as np
import pytest
import torch

from metal_pathtracer_tpu.scene import dsl as jax_dsl
from metal_pathtracer_tpu.scene.meshload import mesh_loader as jax_loader
from metal_pathtracer_tpu.scene.resources import Material as JMaterial
from metal_pathtracer_tpu.scene.resources import Mesh as JMesh
from metal_pathtracer_tpu.scene.resources import SceneResources as JResources
from metal_pathtracer_tpu.settings import RenderSettings as JSettings
from metal_pathtracer_tpu.utils.procgen import dragon_class_mesh as jax_blob
from metal_pathtracer_tpu_torch import constants as C
from metal_pathtracer_tpu_torch.ops import camera as camera_ops
from metal_pathtracer_tpu_torch.ops import intersect
from metal_pathtracer_tpu_torch.ops import rng as rng_ops
from metal_pathtracer_tpu_torch.ops.camera import build_camera
from metal_pathtracer_tpu_torch.ops.kernels import shade, texture
from metal_pathtracer_tpu_torch.renderer.debugprobe import probe_pixel
from metal_pathtracer_tpu_torch.scene import dsl
from metal_pathtracer_tpu_torch.scene.resources import (
    Material,
    Mesh,
    SceneResources,
)
from metal_pathtracer_tpu_torch.schema import (
    settings_to_static,
    settings_to_uniforms,
)
from metal_pathtracer_tpu_torch.settings import BackgroundMode, RenderSettings
from metal_pathtracer_tpu_torch.utils import benchscene, meshfiles
from metal_pathtracer_tpu_torch.utils.image_io import encode_png_u8
from metal_pathtracer_tpu_torch.utils.procgen import icosphere

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_cornell_render import _toy_env  # noqa: E402
from test_torch_prims_render import (  # noqa: E402
    assert_counters,
    assert_gate,
    render_pair,
)

W, H, DEPTH = 40, 24, 4


@pytest.fixture(autouse=True)
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _transforms():
    """``tests/test_instancing.py:_transforms``."""
    out = []
    for i, (tx, s, ry) in enumerate([(-2.2, 0.8, 0.3), (0.0, 1.0, 0.0),
                                     (2.3, 1.25, -0.7)]):
        c, sn = math.cos(ry), math.sin(ry)
        m = np.eye(4)
        m[:3, :3] = np.array([[c, 0, sn], [0, 1, 0], [-sn, 0, c]]) * s
        m[:3, 3] = [tx, 0.15 * i, 0.0]
        out.append(m)
    return out


def _blob_scene():
    """(port, JAX) settings and resources of scene (a)."""
    pos, normals, faces = jax_blob(2)
    uv = np.zeros((len(pos), 2), np.float32)
    tan = np.zeros((len(pos), 4), np.float32)
    js, jr = JSettings(), JResources()
    ps, pr = RenderSettings(), SceneResources()
    for s in (js, ps):
        s.cameraTarget = (0.0, 0.0, 0.0)
        s.cameraDistance = 7.0
        s.cameraPitch = 0.35
        s.fixedRngSeed = 55
    jr.add_material(JMaterial(base_color=(0.7, 0.6, 0.5)))
    pr.add_material(Material(base_color=(0.7, 0.6, 0.5)))
    jsrc = JMesh("blob", pos, normals, uv, uv.copy(), tan, faces, 0)
    psrc = Mesh("blob", pos, normals, uv, uv.copy(), tan, faces, 0)
    for m in _transforms():
        jr.add_mesh_instance(jsrc, m, 0)
        pr.add_mesh_instance(psrc, m, 0)
    return (ps, pr), (js, jr)


def _mixed_files(tmp):
    """Scene (b)'s files in ``tmp``: the GLB soup, the glass OBJ, the blob
    PLY and the ``.scene``; returns its path."""
    verts, faces = icosphere(2)
    zeros2 = np.zeros((len(verts), 2), np.float32)
    zeros4 = np.zeros((len(verts), 4), np.float32)
    uv = np.stack([0.5 + np.arctan2(verts[:, 2], verts[:, 0]) / (2 * np.pi),
                   0.5 - np.arcsin(np.clip(verts[:, 1], -1, 1)) / np.pi],
                  -1).astype(np.float32)
    ball = Mesh("ball", (0.5 * verts).astype(np.float32),
                verts.astype(np.float32), uv, uv.copy(), zeros4,
                faces.astype(np.int32), 0)
    s = 4.0
    quad = Mesh("ground", np.array([[-s, -0.6, -s], [s, -0.6, -s],
                                    [s, -0.6, s], [-s, -0.6, s]],
                                   np.float32),
                np.tile(np.array([[0.0, 1.0, 0.0]], np.float32), (4, 1)),
                np.array([[0, 0], [4, 0], [4, 4], [0, 4]], np.float32),
                np.zeros((4, 2), np.float32), np.zeros((4, 4), np.float32),
                np.array([[0, 2, 1], [0, 3, 2]], np.int32), 1)
    rng = np.random.default_rng(5)
    mr = np.stack([np.zeros((16, 16)), rng.integers(150, 256, (16, 16)),
                   rng.integers(0, 80, (16, 16))], -1).astype(np.uint8)
    checker = benchscene.checker_texture()[..., :3]
    meshfiles.write_glb(
        os.path.join(tmp, "props.glb"), [ball, quad],
        [{"name": "checker", "pbrMetallicRoughness": {
            "baseColorTexture": {"index": 0}, "metallicFactor": 0.15,
            "roughnessFactor": 0.55}},
         {"name": "ground", "pbrMetallicRoughness": {
             "baseColorFactor": [0.45, 0.45, 0.48, 1.0],
             "metallicRoughnessTexture": {"index": 1},
             "metallicFactor": 0.5, "roughnessFactor": 1.0}}],
        [encode_png_u8(checker), encode_png_u8(mr)],
        nodes=[{"mesh": 0, "name": "ball", "translation": [0.0, -0.1, 0.9]},
               {"mesh": 1, "name": "ground"}])
    gv, gf = icosphere(2)
    meshfiles.write_obj(os.path.join(tmp, "glass.obj"), Mesh(
        "glass", (0.4 * gv).astype(np.float32), gv.astype(np.float32),
        zeros2, zeros2.copy(), zeros4, gf.astype(np.int32), 0))
    pos, normals, bf = jax_blob(2)
    meshfiles.write_ply(os.path.join(tmp, "blob.ply"), Mesh(
        "blob", (0.5 * pos).astype(np.float32), normals,
        np.zeros((len(pos), 2), np.float32),
        np.zeros((len(pos), 2), np.float32),
        np.zeros((len(pos), 4), np.float32), bf.astype(np.int32), 0))
    path = os.path.join(tmp, "mixed.scene")
    with open(path, "w") as fh:
        fh.write(
            "camera target=0,0,0 distance=4.2 yaw=0.3 pitch=0.25 vfov=45\n"
            "renderer maxDepth=4 seed=29\n"
            "material type=glass ior=1.5 sigmaA=0.08,0.02,0.02 name=glass\n"
            "mesh path=props.glb\n"
            "mesh path=glass.obj material=glass instanced=1 "
            "translate=-0.9,0.1,0.2\n"
            "mesh path=glass.obj material=glass instanced=1 "
            "translate=1.2,0.3,-0.6 scale=0.7\n"
            "mesh path=blob.ply material=1 instanced=1 "
            "translate=0.6,0.1,-0.8 rotate=0,25,0 scale=1.3\n"
            "mesh path=blob.ply material=1 instanced=1 "
            "translate=-0.9,0.0,-0.9 rotate=10,-40,0 scale=0.9\n")
    return path


def _environment(settings):
    settings.backgroundMode = BackgroundMode.ENVIRONMENT


@pytest.fixture(scope="module")
def blob():
    port, jax = _blob_scene()
    return render_pair(port, jax, W, H, DEPTH)


@pytest.fixture(scope="module")
def mixed(tmp_path_factory):
    path = _mixed_files(str(tmp_path_factory.mktemp("mixed")))
    ps, pr, js, jr = RenderSettings(), SceneResources(), JSettings(), \
        JResources()
    dsl.load_scene_file(path, ps, pr)
    jax_dsl.load_scene_file(path, js, jr, mesh_loader=jax_loader)
    before = texture.texture_stage.launches
    textured = []

    def spy(*args):
        out = texture.texture_stage(*args)
        kind = args[-1]
        tpbr = out[:, texture.TEX_IDX["tpbr"]] > 0.5
        textured.append(int((tpbr & (kind >= intersect.KIND_INSTANCE)).sum()))
        return out

    shade.texture_stage = spy
    try:
        r = render_pair((ps, pr), (js, jr), W, H, DEPTH, _environment,
                        _toy_env())
    finally:
        shade.texture_stage = texture.texture_stage
    r["resources"], r["settings"] = pr, ps
    r["texture_launches"] = texture.texture_stage.launches - before
    r["instanced_textured"] = textured
    return r


def test_blob_matches_jax(blob):
    assert_gate(blob, 2e-4, 0.98)


def test_blob_counters(blob):
    """Every pixel sampled, the image finite and lit, no shadow trace (no
    light integral), no kernel launched on the CPU."""
    assert_counters(blob, shadow=False)


def test_mixed_matches_jax(mixed):
    assert_gate(mixed, 2e-4, 0.98)


def test_mixed_counters(mixed):
    """The scene really is two groups of two placements beside a textured
    soup, the instanced PBR placements bound to the checker texture and
    textured (with the soup's UVs) at every depth's stage, a dielectric
    placement, shadow rays traced, nothing launched."""
    assert_counters(mixed, shadow=True)
    assert mixed["texture_launches"] == 0
    assert mixed["instanced_textured"][0] > 50
    scene = mixed["resources"].build_arrays(device="cpu")
    assert [g.count for g in scene.instanced] == [2, 2]
    assert scene.n_triangles > 0
    mats = mixed["resources"].materials
    checker = scene.instanced[1].material.tolist()
    assert checker == [1, 1] and mats[1].texture_indices[0] >= 0
    assert scene.instanced[0].material.tolist() == [0, 0]


def test_probe_reports_the_global_instance_id(mixed):
    """``probe_pixel`` on a pixel whose camera ray hits a placement: its
    first row names the hit as the JAX package's record does
    (``PROBE_FIELDS``): a triangle, the object triangle, the global
    instance id (``base_id`` + placement) and the placement's material."""
    ps, pr = mixed["settings"], mixed["resources"]
    scene = pr.build_arrays(environment=_toy_env()[0], device="cpu")
    static = settings_to_static(ps, W, H, pr.material_types_present(),
                                pr.texture_slots_present(),
                                pr.texture_uses_uv1())
    uni = settings_to_uniforms(ps, build_camera(ps, W, H, device="cpu"), 0,
                               0)
    flat = torch.arange(W * H)
    xs, ys = flat % W, flat // W
    seed = rng_ops.make_seed(uni.fixed_rng_seed, 0, xs, ys, 0,
                             torch.zeros_like(xs))
    _, ro, rd = camera_ops.generate_primary_rays(uni.camera, xs, ys, W, H,
                                                 seed)
    _, idx, _, _, kind = intersect.trace_merged(
        ro, rd, scene, C.EPSILON_T, torch.full((W * H,), C.INFINITY_T))
    lanes = torch.nonzero(kind >= intersect.KIND_INSTANCE).squeeze(1)
    assert lanes.numel() > 20
    lane = int(lanes[lanes.numel() // 2])
    k = int(kind[lane]) - intersect.KIND_INSTANCE
    row = probe_pixel(scene, uni, static, lane % W, lane // W)[0]
    group = 0 if k < scene.instanced[0].count else 1
    assert row["hit"] == 1.0 and row["prim_type"] == C.PRIMITIVE_TRIANGLE
    assert row["prim_index"] == float(idx[lane])
    assert row["mesh_index"] == float(scene.instanced[0].base_id + k)
    assert row["mesh_index"] >= len(pr.meshes)
    assert row["material"] == float(scene.instanced[group].material[0])

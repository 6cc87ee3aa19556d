"""A generated glTF scene end to end, the port against the JAX package's
XLA render: a GLB written by the test (``utils/meshfiles.py``) holds a
normal-mapped PBR icosphere (roughness 0.6 times an ORM texture's green
channel of at least 0.85; base colour from a 48x40 sRGB texture, which
the atlas resamples to 32x32; MikkTSpace tangents, since the file has
none) and a textured PBR ground quad of roughness 0.9 with a
KHR_texture_transform. A ``.scene`` file places it with a ``mesh``
record beside a lambert sphere, under the 32x16 HDR environment with a
sun block (``test_torch_cornell_render._toy_env``); each package parses
the file with its own DSL and loaders. 40x24, 2 spp, maxDepth 4. One JAX
render in the file.

The gate is the ladder's tight image gate: RMSE < 2e-4, more than 98 %
of pixels within 1e-5, ray and shadow counts within max(4, 1e-4 * rays).
"""

import numpy as np
import pytest
import torch

from metal_pathtracer_tpu.scene import dsl as jax_dsl
from metal_pathtracer_tpu.scene.meshload import mesh_loader as jax_loader
from metal_pathtracer_tpu.scene.resources import SceneResources as JResources
from metal_pathtracer_tpu.settings import RenderSettings as JSettings
from metal_pathtracer_tpu_torch.ops.kernels import texture
from metal_pathtracer_tpu_torch.scene import dsl
from metal_pathtracer_tpu_torch.scene.resources import Mesh, SceneResources
from metal_pathtracer_tpu_torch.settings import BackgroundMode, RenderSettings
from metal_pathtracer_tpu_torch.utils import meshfiles
from metal_pathtracer_tpu_torch.utils.image_io import encode_png_u8
from metal_pathtracer_tpu_torch.utils.procgen import icosphere
from test_torch_cornell_render import _toy_env
from test_torch_loaders import png
from test_torch_prims_render import assert_counters, assert_gate, render_pair

W, H, DEPTH = 40, 24, 4


@pytest.fixture(autouse=True)
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _images():
    rng = np.random.default_rng(17)
    base = rng.integers(40, 256, (40, 48, 3), dtype=np.uint8)
    # a normal map: tangent-space normals tilted by up to ~35 degrees
    t = rng.uniform(-0.6, 0.6, (32, 32, 2))
    n = np.concatenate([t, np.ones((32, 32, 1))], -1)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    normal = np.round((n * 0.5 + 0.5) * 255).astype(np.uint8)
    orm = np.stack([rng.integers(150, 256, (16, 16)),
                    rng.integers(217, 256, (16, 16)),
                    rng.integers(0, 120, (16, 16))], -1).astype(np.uint8)
    ground = rng.integers(60, 200, (16, 16, 4), dtype=np.uint8)
    ground[..., 3] = 255
    return [encode_png_u8(base), encode_png_u8(normal), png(orm, 2),
            png(ground, 6)]


def _meshes():
    verts, faces = icosphere(3)
    uv = np.stack([0.5 + np.arctan2(verts[:, 2], verts[:, 0]) / (2 * np.pi),
                   0.5 - np.arcsin(np.clip(verts[:, 1], -1, 1)) / np.pi],
                  -1).astype(np.float32)
    ball = Mesh("ball", (verts * 0.6).astype(np.float32),
                verts.astype(np.float32), uv,
                np.zeros_like(uv), np.zeros((len(verts), 4), np.float32),
                faces.astype(np.int32), material=0)
    s = 4.0
    quad = Mesh("ground", np.array([[-s, -0.6, -s], [s, -0.6, -s],
                                    [s, -0.6, s], [-s, -0.6, s]],
                                   np.float32),
                np.tile(np.array([[0.0, 1.0, 0.0]], np.float32), (4, 1)),
                np.array([[0, 0], [4, 0], [4, 4], [0, 4]], np.float32),
                np.zeros((4, 2), np.float32), np.zeros((4, 4), np.float32),
                np.array([[0, 2, 1], [0, 3, 2]], np.int32), material=1)
    return [ball, quad]


_MATERIALS = [
    {"name": "mapped", "pbrMetallicRoughness": {
        "baseColorTexture": {"index": 0},
        "metallicRoughnessTexture": {"index": 2},
        "metallicFactor": 0.5, "roughnessFactor": 0.6},
     "normalTexture": {"index": 1, "scale": 1.0},
     "occlusionTexture": {"index": 2}},
    {"name": "floor", "pbrMetallicRoughness": {
        "baseColorTexture": {"index": 3, "extensions": {
            "KHR_texture_transform": {"scale": [0.5, 0.5],
                                      "rotation": 0.4}}},
        "metallicFactor": 0.0, "roughnessFactor": 0.9}},
]


def _scene_file(tmp_path):
    meshfiles.write_glb(str(tmp_path / "mapped.glb"), _meshes(), _MATERIALS,
                        _images(), nodes=[
                            {"mesh": 0, "name": "ball",
                             "translation": [0.0, 0.05, 0.0],
                             "rotation": [0.0, 0.25881905, 0.0,
                                          0.96592583]},
                            {"mesh": 1, "name": "ground"}])
    path = tmp_path / "mapped.scene"
    path.write_text(
        "camera target=0,0,0 distance=3.2 yaw=0.5 pitch=0.25 vfov=40\n"
        "renderer maxDepth=4 seed=23\n"
        "material type=lambert albedo=0.6,0.55,0.5\n"
        "sphere center=1.3,-0.25,-0.4 radius=0.35 material=0\n"
        "mesh path=mapped.glb\n")
    return path


def _environment(settings):
    settings.backgroundMode = BackgroundMode.ENVIRONMENT


@pytest.fixture(scope="module")
def renders(tmp_path_factory):
    path = _scene_file(tmp_path_factory.mktemp("gltf"))
    ps, pr, js, jr = RenderSettings(), SceneResources(), JSettings(), \
        JResources()
    dsl.load_scene_file(str(path), ps, pr)
    jax_dsl.load_scene_file(str(path), js, jr, mesh_loader=jax_loader)
    before = texture.texture_stage.launches
    r = render_pair((ps, pr), (js, jr), W, H, DEPTH, _environment,
                    _toy_env())
    r["resources"] = pr
    r["texture_launches"] = texture.texture_stage.launches - before
    return r


def test_gltf_render_matches_jax(renders):
    assert_gate(renders, 2e-4, 0.98)


def test_gltf_render_counters(renders):
    """Every pixel sampled, the image finite and lit, shadow rays traced,
    no kernel launched on the CPU; the scene really is textured, normal
    mapped, resampled and rough."""
    assert_counters(renders, shadow=True)
    assert renders["texture_launches"] == 0
    pr = renders["resources"]
    assert [im.shape[:2] for im in pr.texture_images] == \
        [(40, 48), (16, 16), (32, 32), (16, 16)]
    mapped = pr.materials[1]
    assert mapped.texture_indices[2] >= 0 and mapped.pbr_roughness >= 0.5
    assert np.abs(pr.meshes[0].tangents[:, :3]).sum() > 0

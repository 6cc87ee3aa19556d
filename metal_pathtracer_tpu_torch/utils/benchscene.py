"""The bench's scenes, built with the port's own scene classes (numpy
only, the JAX package's ``utils/benchscene.py`` and ``bench.py:261-280``
value for value):

- ``build_lambert_series``: one lambert displaced icosphere under the
  gradient sky, maxDepth 8, seed 1234;
- ``build_bench_scene``: the headline, a 1.31M-triangle displaced
  icosphere, a glass icosphere (dielectric, absorbing interior) and a PBR
  icosphere with a 512x512 sRGB checker base-colour texture on a lambert
  ground under a 1024x512 HDR sun/sky with alias-table NEE, maxDepth 8,
  1920x1080, seed 1234, spec-NEE on and MNEE off;
- ``build_refdefault_scene``: the same scene at the reference's default
  workload shape, 1280x720 and maxDepth 20 (``bench.py:250-260``);
- ``build_untextured_bench_scene``: the headline with its texture cleared
  and every ``texture_indices`` set to -1, exactly as the JAX package's
  ``tests/test_fused_shade.py`` ``_bench_like_scene(textured=False)`` does;
- ``build_six_slot_scene``: a small test scene that binds all six texture
  slots (the headline binds only the base colour): four PBR icospheres on
  a lambert ground, with a normal map on tangents of handedness +1 and -1
  and on zero tangents (the ONB fallback), ORM, occlusion, emissive and
  transmission, UV set 1 and a KHR transform, alpha MASK and BLEND.

The analytic-primitive scenes are ``.scene`` DSL text (the repository's
files ``CORNELL_PATH`` and ``SMOKE_PATH``, and ``rtow_scene_text``), so
that the JAX package's parser can read the same text:

- ``build_cornell_scene``: ``assets/scenes/cornell.scene`` as written, six
  rectangles (one an area light), a mirror and a glass sphere, gradient
  sky, 512x512, maxDepth 8, seed 7;
- ``build_rtow_scene``: the final scene of *Ray Tracing in One Weekend*
  (v4), ~485 spheres of lambert, metal and glass, thin-lens camera,
  gradient sky, 1200x675, maxDepth 50;
- ``build_smoke_scene``: ``tests/scenes/smoke.scene``, two lambert spheres
  under a solid sky, 64x64, maxDepth 4;
- ``build_mixed_scene``: every primitive family in one frame, the JAX
  package's fused-shade test scene (``tests/test_fused_shade.py:166-196``):
  a displaced icosphere, a lambert and an emissive sphere and a lambert
  rectangle under the gradient sky, maxDepth 5.

The material zoo (``assets/scenes/materials.scene``, the reference's
material row) and its variants:

- ``build_materials_scene``: the file as written, lambert, brushed metal,
  glass, plastic, carpaint and separable-SSS spheres on a ground sphere,
  gradient sky, 960x320, maxDepth 8, seed 42;
- ``build_materials_env_rw_scene``: the same file with the headline's
  procedural HDR sun/sky (``hdr_sky(1024, 512)``) and ``sss=randomwalk``
  with the skin material's ``method=randomwalk`` (``sssMaxSteps`` at its
  default 32);
- ``build_cornell_emitenv_scene``: ``assets/scenes/cornell.scene`` with
  ``emitEnv=1`` on the lamp's material, under the same HDR sky: rect and
  environment NEE together, the lamp's emission modulated by the sky.
"""

from __future__ import annotations

import pathlib

import numpy as np

from metal_pathtracer_tpu_torch import constants as C
from metal_pathtracer_tpu_torch.ops import env as env_ops
from metal_pathtracer_tpu_torch.scene import dsl
from metal_pathtracer_tpu_torch.scene.resources import (
    Material,
    Mesh,
    Rect,
    SceneResources,
    Sphere,
)
from metal_pathtracer_tpu_torch.settings import BackgroundMode, RenderSettings
from metal_pathtracer_tpu_torch.utils.procgen import (
    dragon_class_scene_mesh,
    icosphere,
)


def build_lambert_series(subdivisions: int = 7):
    """Returns (settings, resources); 327,680 triangles at the bench's
    subdivision 7."""
    settings = RenderSettings()
    settings.cameraTarget = (0.0, 0.0, 0.0)
    settings.cameraDistance = 3.2
    settings.cameraYaw = 0.4
    settings.cameraPitch = 0.25
    settings.cameraVerticalFov = 40.0
    settings.maxDepth = 8
    settings.fixedRngSeed = 1234
    resources = SceneResources()
    resources.add_material(Material(base_color=(0.7, 0.7, 0.7)))
    resources.add_mesh(dragon_class_scene_mesh(subdivisions, material=0))
    return settings, resources


def hdr_sky(width: int = 1024, height: int = 512,
            sun_radiance: float = 1500.0) -> np.ndarray:
    """(H,W,3) linear-radiance equirect sky: gradient + horizon glow + a
    ~0.9deg sun disc carrying most of the power (so alias NEE matters)."""
    v = (np.arange(height) + 0.5) / height          # 0 top .. 1 bottom
    u = (np.arange(width) + 0.5) / width
    theta = v * np.pi                                # polar from +Y
    phi = u * 2.0 * np.pi
    st = np.sin(theta)[:, None]
    dirs = np.stack(np.broadcast_arrays(
        st * np.cos(phi)[None, :],
        np.cos(theta)[:, None] * np.ones((1, width)),
        st * np.sin(phi)[None, :]), -1)

    y = dirs[..., 1]
    t = 0.5 * (y + 1.0)
    sky = (1.0 - t)[..., None] * np.array([1.0, 1.0, 1.0]) \
        + t[..., None] * np.array([0.35, 0.55, 0.95])
    # horizon glow
    sky += np.exp(-np.abs(y)[..., None] * 6.0) * np.array([0.5, 0.35, 0.2])

    sun_dir = np.array([0.45, 0.72, 0.53])
    sun_dir /= np.linalg.norm(sun_dir)
    cos = np.clip(dirs @ sun_dir, -1.0, 1.0)
    # disc ~0.9deg diameter + soft aureole
    disc = (cos > np.cos(np.radians(0.45))).astype(np.float64)
    aureole = np.exp((cos - 1.0) * 2500.0)
    sun = (sun_radiance * disc + 40.0 * aureole)[..., None] \
        * np.array([1.0, 0.93, 0.82])
    return (sky + sun).astype(np.float32)


def checker_texture(size: int = 512, tiles: int = 16) -> np.ndarray:
    """RGBA uint8 checker with per-tile tint (the PBR sphere's base colour
    texture in the headline)."""
    ij = np.arange(size) * tiles // size
    checker = (ij[:, None] + ij[None, :]) % 2
    rng = np.random.default_rng(11)
    tint = rng.uniform(0.3, 1.0, (tiles, tiles, 3))
    tint_img = tint[ij[:, None].repeat(size, 1), ij[None, :].repeat(size, 0)]
    rgb = np.where(checker[..., None] > 0, tint_img, 0.12 + 0.0 * tint_img)
    out = np.zeros((size, size, 4), np.uint8)
    out[..., :3] = np.clip(rgb * 255.0, 0, 255).astype(np.uint8)
    out[..., 3] = 255
    return out


def _sphere_mesh(subdivisions, center, radius, material, name):
    verts, faces = icosphere(subdivisions)
    pos = (verts * radius + np.asarray(center)).astype(np.float32)
    normals = verts.astype(np.float32)
    # equirect UVs (enough for a checker; seam tris are fine at bench scale)
    uv = np.stack([
        0.5 + np.arctan2(verts[:, 2], verts[:, 0]) / (2.0 * np.pi),
        0.5 - np.arcsin(np.clip(verts[:, 1], -1, 1)) / np.pi], -1
    ).astype(np.float32)
    return Mesh(name=name, vertices=pos, normals=normals, uv0=uv,
                uv1=uv.copy(), tangents=np.zeros((len(pos), 4), np.float32),
                indices=faces.astype(np.int32), material=material)


def _ground_mesh(material):
    s, y = 30.0, -1.08
    pos = np.array([[-s, y, -s], [s, y, -s], [s, y, s], [-s, y, s]],
                   np.float32)
    n = np.tile(np.array([[0.0, 1.0, 0.0]], np.float32), (4, 1))
    uv = np.array([[0, 0], [8, 0], [8, 8], [0, 8]], np.float32)
    faces = np.array([[0, 2, 1], [0, 3, 2]], np.int32)
    return Mesh(name="ground", vertices=pos, normals=n, uv0=uv,
                uv1=uv.copy(), tangents=np.zeros((4, 4), np.float32),
                indices=faces, material=material)


def build_bench_scene(subdivisions: int = 8, device="cuda"):
    """Returns (settings, resources, environment) for the headline bench,
    the environment built on ``device``.

    subdivisions=8 -> 20*4^8 = 1,310,720 dragon triangles (+ 2x 5,120-tri
    prop spheres + 2 ground tris).
    """
    settings = RenderSettings()
    settings.cameraTarget = (0.0, -0.1, 0.0)
    settings.cameraDistance = 4.2
    settings.cameraYaw = 0.4
    settings.cameraPitch = 0.18
    settings.cameraVerticalFov = 40.0
    settings.maxDepth = 8
    settings.fixedRngSeed = 1234
    settings.backgroundMode = BackgroundMode.ENVIRONMENT
    # reference defaults: spec-NEE on, MNEE off (RenderSettings.h)
    settings.enableSpecularNee = True
    settings.enableMnee = False

    res = SceneResources()
    m_dragon = res.add_material(Material(base_color=(0.72, 0.68, 0.62),
                                         name="dragon"))
    m_glass = res.add_material(Material(
        mat_type=C.MATERIAL_DIELECTRIC, base_color=(1.0, 1.0, 1.0), ior=1.5,
        dielectric_sigma_a=(0.08, 0.02, 0.02), name="glass"))
    res.texture_images.append(checker_texture())
    res.texture_srgb.append(True)
    res.texture_wrap.append((0, 0))
    m_pbr = res.add_material(Material(
        mat_type=C.MATERIAL_PBR, base_color=(1.0, 1.0, 1.0),
        roughness=0.35, pbr_metallic=0.15,
        texture_indices=(0, -1, -1, -1, -1, -1), name="checker"))
    m_ground = res.add_material(Material(base_color=(0.45, 0.45, 0.48),
                                         name="ground"))

    res.add_mesh(dragon_class_scene_mesh(subdivisions, material=m_dragon))
    res.add_mesh(_sphere_mesh(4, (-1.55, -0.45, 0.95), 0.62, m_glass,
                              "glass-sphere"))
    res.add_mesh(_sphere_mesh(4, (1.65, -0.5, 1.05), 0.58, m_pbr,
                              "checker-sphere"))
    res.add_mesh(_ground_mesh(m_ground))
    return settings, res, env_ops.environment_from_texels(hdr_sky(), device)


#: (width, height) of the refdefault cell
REFDEFAULT_FRAME = (1280, 720)


def build_refdefault_scene(subdivisions: int = 8, device="cuda"):
    """The headline scene at maxDepth 20, to render at
    ``REFDEFAULT_FRAME``; returns (settings, resources, environment)."""
    settings, res, environment = build_bench_scene(subdivisions, device)
    settings.maxDepth = 20
    return settings, res, environment


def build_untextured_bench_scene(subdivisions: int = 8, device="cuda"):
    """The headline with its texture cleared (``_bench_like_scene(False)``
    of the JAX package's tests); returns (settings, resources,
    environment)."""
    settings, res, environment = build_bench_scene(subdivisions, device)
    res.texture_images.clear()
    res.texture_srgb.clear()
    res.texture_wrap.clear()
    for m in res.materials:
        m.texture_indices = (-1, -1, -1, -1, -1, -1)
    return settings, res, environment


def _six_slot_images(seed=21):
    """Six seeded RGBA textures of power-of-two sizes: base colour with a
    varying alpha, ORM, a normal map, occlusion, emissive, transmission;
    with their sRGB flags and wrap modes."""
    rng = np.random.default_rng(seed)
    img = lambda h, w: rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
    base = img(32, 32)
    orm = img(16, 16)
    normal = img(32, 16)
    normal[..., 0:2] = rng.integers(60, 196, (32, 16, 2))
    normal[..., 2] = rng.integers(200, 256, (32, 16))
    return ([base, orm, normal, img(16, 16), img(16, 8), img(8, 8)],
            [True, False, False, False, True, False],
            [(0, 0), (1, 2), (2, 1), (0, 1), (2, 0), (1, 1)])


def _tangent_sphere(subdivisions, center, radius, material, tangents, name):
    """An icosphere with equirect UVs, a second UV set (2 uv + 0.1) and,
    with ``tangents``, tangents along +phi of handedness +1 on the upper
    and -1 on the lower hemisphere (zero tangents otherwise)."""
    verts, faces = icosphere(subdivisions)
    uv = np.stack([0.5 + np.arctan2(verts[:, 2], verts[:, 0]) / (2 * np.pi),
                   0.5 - np.arcsin(np.clip(verts[:, 1], -1, 1)) / np.pi],
                  -1).astype(np.float32)
    tan = np.zeros((len(verts), 4), np.float32)
    if tangents:
        tan[:, 0] = -verts[:, 2]
        tan[:, 2] = verts[:, 0]
        tan[:, 3] = np.where(verts[:, 1] >= 0, 1.0, -1.0)
    return Mesh(name=name,
                vertices=(verts * radius + np.asarray(center)
                          ).astype(np.float32),
                normals=verts.astype(np.float32), uv0=uv,
                uv1=(uv * 2.0 + 0.1).astype(np.float32), tangents=tan,
                indices=faces.astype(np.int32), material=material)


def build_six_slot_scene(subdivisions: int = 3):
    """Returns (settings, resources): the six-slot test scene, framed
    for a 3:2 image (no environment; the texture stage needs none)."""
    settings = RenderSettings()
    settings.cameraTarget = (0.0, 0.0, 0.0)
    settings.cameraDistance = 4.5
    settings.cameraYaw = 1.5708
    settings.cameraPitch = 0.25
    settings.cameraVerticalFov = 45.0
    res = SceneResources()
    images, srgb, wraps = _six_slot_images()
    res.texture_images.extend(images)
    res.texture_srgb.extend(srgb)
    res.texture_wrap.extend(wraps)
    tf = np.zeros((6, 2, 3), np.float32)
    tf[:, 0, 0] = tf[:, 1, 1] = 1.0
    c, s = np.cos(0.4), np.sin(0.4)
    tf[0] = [[1.5 * c, -1.5 * s, 0.2], [1.5 * s, 1.5 * c, -0.1]]
    pbr = C.MATERIAL_PBR
    for m in (
            Material(base_color=(0.5, 0.5, 0.5), name="ground"),
            Material(mat_type=pbr, base_color=(0.9, 0.8, 0.7), roughness=0.5,
                     pbr_metallic=0.4, pbr_transmission=0.3,
                     pbr_occlusion_strength=0.8, pbr_normal_scale=1.2,
                     emission=(1.0, 0.5, 0.2),
                     texture_indices=(0, 1, 2, 3, 4, 5),
                     texture_uv_set=(0, 0, 1, 1, 0, 1), texture_transform=tf,
                     name="every-slot"),
            Material(mat_type=pbr, roughness=0.3, pbr_alpha=0.9,
                     pbr_alpha_mode=1, pbr_alpha_cutoff=0.5,
                     texture_indices=(0, -1, -1, -1, -1, -1), name="mask"),
            Material(mat_type=pbr, roughness=0.6, pbr_alpha=0.7,
                     pbr_alpha_mode=2, texture_indices=(0, 1, -1, -1, -1, -1),
                     name="blend"),
            Material(mat_type=pbr, roughness=0.2,
                     texture_indices=(-1, -1, 2, -1, -1, -1),
                     name="onb-normal")):
        res.add_material(m)
    g, y = 6.0, -0.6
    quad = np.array([[0, 0], [4, 0], [4, 4], [0, 4]], np.float32)
    res.add_mesh(Mesh(
        name="ground",
        vertices=np.array([[-g, y, -g], [g, y, -g], [g, y, g], [-g, y, g]],
                          np.float32),
        normals=np.tile(np.array([[0.0, 1.0, 0.0]], np.float32), (4, 1)),
        uv0=quad, uv1=quad.copy(), tangents=np.zeros((4, 4), np.float32),
        indices=np.array([[0, 2, 1], [0, 3, 2]], np.int32), material=0))
    for k, (x, r, tangents) in enumerate(((-1.5, 0.6, True),
                                          (-0.4, 0.5, True),
                                          (0.6, 0.5, True),
                                          (1.6, 0.5, False))):
        res.add_mesh(_tangent_sphere(subdivisions, (x, 0.0, 0.0), r, k + 1,
                                     tangents, res.materials[k + 1].name))
    return settings, res


#: the repository's scene files of the Cornell box and the smoke scene
_REPO = pathlib.Path(__file__).resolve().parents[2]
CORNELL_PATH = _REPO / "assets" / "scenes" / "cornell.scene"
SMOKE_PATH = _REPO / "tests" / "scenes" / "smoke.scene"
MATERIALS_PATH = _REPO / "assets" / "scenes" / "materials.scene"


def cornell_scene_text() -> str:
    """The text of ``assets/scenes/cornell.scene``."""
    return CORNELL_PATH.read_text()


#: (width, height) of the cornell, rtow and smoke cells
CORNELL_FRAME = (512, 512)
RTOW_FRAME = (1200, 675)
SMOKE_FRAME = (64, 64)
MATERIALS_FRAME = (960, 320)


def rtow_scene_text(seed: int = 0) -> str:
    """The final scene of Peter Shirley's *Ray Tracing in One Weekend*
    (v4, "Where Next?") in the DSL: a lambert ground sphere (radius 1000,
    albedo 0.5), for a, b in [-11, 11) a small sphere of radius 0.2 at
    (a + 0.9 xi, 0.2, b + 0.9 xi) unless within 0.9 of (4, 0.2, 0) (xi <
    0.8: lambert, albedo xi*xi per channel; < 0.95: metal, albedo U(0.5,
    1), roughness = the book's fuzz U(0, 0.5); else glass, ior 1.5), and
    three spheres of radius 1 (glass, lambert (0.4, 0.2, 0.1), a mirror
    (0.7, 0.6, 0.5)). Camera: vfov 20 from (13, 2, 3) at the origin,
    defocus angle 0.6, focus distance 10. The xi come from
    ``numpy.random.default_rng(seed)`` in the book's draw order, so the
    layout is the book's and the draws are not."""
    rng = np.random.default_rng(seed)
    f3 = lambda v: ",".join(f"{x:.6f}" for x in v)
    lines = [
        "# Ray Tracing in One Weekend, final scene (book v4, Where Next?)",
        "camera target=0,0,0 distance=13.4907 yaw=0.22689 pitch=0.14884 "
        "vfov=20 defocusAngle=0.6 focusDist=10",
        f"renderer maxDepth=50 width={RTOW_FRAME[0]} height={RTOW_FRAME[1]}",
    ]
    n_mat = 0

    def add(material, center, radius):
        nonlocal n_mat
        lines.append(f"material {material}")
        lines.append(f"sphere center={f3(center)} radius={radius} "
                     f"material={n_mat}")
        n_mat += 1

    add("type=lambert albedo=0.5,0.5,0.5", (0.0, -1000.0, 0.0), 1000)
    for a in range(-11, 11):
        for b in range(-11, 11):
            choose = rng.random()
            center = (a + 0.9 * rng.random(), 0.2, b + 0.9 * rng.random())
            if np.linalg.norm(np.subtract(center, (4.0, 0.2, 0.0))) <= 0.9:
                continue
            if choose < 0.8:
                albedo = rng.random(3) * rng.random(3)
                add(f"type=lambert albedo={f3(albedo)}", center, 0.2)
            elif choose < 0.95:
                albedo = rng.uniform(0.5, 1.0, 3)
                fuzz = rng.uniform(0.0, 0.5)
                add(f"type=metal albedo={f3(albedo)} roughness={fuzz:.6f}",
                    center, 0.2)
            else:
                add("type=glass ior=1.5", center, 0.2)
    add("type=glass ior=1.5", (0.0, 1.0, 0.0), 1)
    add("type=lambert albedo=0.4,0.2,0.1", (-4.0, 1.0, 0.0), 1)
    add("type=metal albedo=0.7,0.6,0.5 roughness=0", (4.0, 1.0, 0.0), 1)
    return "\n".join(lines) + "\n"


def _parse(text: str):
    settings, res = RenderSettings(), SceneResources()
    dsl.parse_scene(text, settings, res)
    return settings, res


def _load(path):
    settings, res = RenderSettings(), SceneResources()
    dsl.load_scene_file(str(path), settings, res)
    return settings, res


def build_cornell_scene():
    """Returns (settings, resources) of ``assets/scenes/cornell.scene``."""
    return _load(CORNELL_PATH)


def build_rtow_scene(seed: int = 0):
    """Returns (settings, resources) of ``rtow_scene_text(seed)``."""
    return _parse(rtow_scene_text(seed))


def build_smoke_scene():
    """Returns (settings, resources) of ``tests/scenes/smoke.scene``."""
    return _load(SMOKE_PATH)


def build_mixed_scene(subdivisions: int = 2):
    """Returns (settings, resources): triangles, spheres (one of them a
    diffuse light) and a one-sided rectangle, the reference's scene for
    the merged trace's tie order, two-sided emission and triangle-only
    self-exclusion."""
    settings = RenderSettings()
    settings.cameraTarget = (0.0, 0.5, 0.0)
    settings.cameraDistance = 4.5
    settings.cameraYaw = -0.4
    settings.cameraPitch = 0.2
    settings.maxDepth = 5
    settings.fixedRngSeed = 4242
    res = SceneResources()
    m_mesh = res.add_material(Material(base_color=(0.6, 0.3, 0.3)))
    m_s = res.add_material(Material(base_color=(0.3, 0.4, 0.7)))
    m_l = res.add_material(Material(mat_type=C.MATERIAL_DIFFUSE_LIGHT,
                                    emission=(9.0, 8.0, 7.0)))
    m_r = res.add_material(Material(base_color=(0.5, 0.5, 0.45)))
    res.add_mesh(dragon_class_scene_mesh(subdivisions, material=m_mesh))
    res.spheres.append(Sphere(center=(1.4, 0.4, 0.6), radius=0.4,
                              material=m_s))
    res.spheres.append(Sphere(center=(-1.2, 1.6, -0.5), radius=0.35,
                              material=m_l))
    res.rects.append(Rect(
        corner=np.array([-3, -0.8, -3], np.float32),
        edge_u=np.array([6, 0, 0], np.float32),
        edge_v=np.array([0, 0, 6], np.float32),
        normal=np.array([0, 1, 0], np.float32),
        material=m_r, two_sided=False))
    return settings, res


def build_materials_scene():
    """Returns (settings, resources) of ``assets/scenes/materials.scene``."""
    return _load(MATERIALS_PATH)


def materials_env_rw_text() -> str:
    """``materials.scene`` with the random walk for its subsurface sphere:
    ``sss=randomwalk`` and the skin material's ``method=randomwalk``."""
    text = MATERIALS_PATH.read_text()
    for old, new in (("sss=separable", "sss=randomwalk"),
                     ("method=separable", "method=randomwalk")):
        if old not in text:
            raise ValueError(f"{MATERIALS_PATH} has no '{old}'")
        text = text.replace(old, new)
    return text


def build_materials_env_rw_scene(device="cuda"):
    """Returns (settings, resources, environment): ``materials_env_rw_text``
    under the headline's HDR sun/sky (alias NEE), built on ``device``."""
    settings, res = _parse(materials_env_rw_text())
    settings.backgroundMode = BackgroundMode.ENVIRONMENT
    return settings, res, env_ops.environment_from_texels(hdr_sky(), device)


def cornell_emitenv_text() -> str:
    """``cornell.scene`` with ``emitEnv=1`` on the lamp's material."""
    text = cornell_scene_text()
    if "name=lamp" not in text:
        raise ValueError(f"{CORNELL_PATH} has no lamp material")
    return text.replace("name=lamp", "emitEnv=1 name=lamp")


def build_cornell_emitenv_scene(device="cuda"):
    """Returns (settings, resources, environment): ``cornell_emitenv_text``
    under the headline's HDR sun/sky, built on ``device``."""
    settings, res = _parse(cornell_emitenv_text())
    settings.backgroundMode = BackgroundMode.ENVIRONMENT
    return settings, res, env_ops.environment_from_texels(hdr_sky(), device)


#: the material rows of the JAX package's material tests on triangle
#: icospheres (``test_fused_shade.py:796-899``), ``Material`` keyword dicts
ICOSPHERE_ROWS = {
    "plastic": dict(mat_type=C.MATERIAL_PLASTIC, base_color=(0.6, 0.1, 0.1),
                    coat_roughness=0.15, coat_thickness=0.4,
                    coat_tint=(0.9, 0.95, 1.0),
                    coat_absorption=(0.2, 0.1, 0.05), ior=1.5),
    "carpaint": dict(mat_type=C.MATERIAL_CARPAINT,
                     base_color=(0.5, 0.05, 0.05), coat_roughness=0.2,
                     carpaint_base_metallic=0.3, carpaint_base_roughness=0.25,
                     carpaint_flake_sample_weight=0.2,
                     carpaint_flake_roughness=0.2, carpaint_flake_scale=8.0,
                     carpaint_flake_normal_strength=0.5, ior=1.5),
    "sss": dict(mat_type=C.MATERIAL_SUBSURFACE, base_color=(0.8, 0.4, 0.2),
                sss_mfp=0.25, sss_g=0.2, sss_method=0, ior=1.4),
    "ground": dict(base_color=(0.6, 0.6, 0.6)),
}


def build_icosphere_scene(materials, spheres, seed: int):
    """Returns (settings, resources): ``materials`` (``Material`` keyword
    dicts, the last one the ground's), icospheres (subdivision 2) of
    ``(center, radius, material)`` and the ground quad, seen by the camera
    of the JAX package's material tests (``test_fused_shade.py:796-975``),
    maxDepth 4: triangle meshes, where t, u and v of a hit are
    bit-exact."""
    settings = RenderSettings()
    settings.cameraTarget = (0.0, 0.6, 0.0)
    settings.cameraDistance = 5.0
    settings.cameraPitch = 0.3
    settings.maxDepth = 4
    settings.fixedRngSeed = seed
    res = SceneResources()
    for kw in materials:
        res.add_material(Material(**kw))
    for i, (center, radius, material) in enumerate(spheres):
        res.add_mesh(_sphere_mesh(2, center, radius, material, f"sphere{i}"))
    res.add_mesh(_ground_mesh(len(materials) - 1))
    return settings, res

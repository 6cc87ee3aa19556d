"""The port's plastic, carpaint and subsurface BSDFs lane by lane against
the JAX package's jitted functions, on 8,192 numpy lanes over the material
rows below (front-facing and grazing lanes, random hit positions):

- ``sample_bsdf`` (plastic, carpaint, separable SSS and the fallback):
  the RNG state after sampling, the lobe type, ``is_bssrdf``,
  ``has_exit_point`` and the validity of every sample exact; on the
  well-conditioned lanes directions within ``DIR_ATOL`` = 32 float32 ulps
  of 1 (measured 21, on a rough carpaint lane near normal incidence; 11
  on every other material), weights and
  pdfs within ``RTOL`` = 4e-5 relative (measured 2.0e-5), and exit points
  within ``POS_ATOL`` = 1e-6 (measured 2.4e-7). ``_loose`` computes the
  ill-conditioned lanes from the inputs, and they get
  ``LOOSE_DIR_ATOL`` = 8e-5 and ``LOOSE_RTOL`` = 6.5e-3, about three times
  the largest readings there (2.8e-5 and 2.14e-3):
  - a plastic or carpaint lane with a GGX lobe at alpha^2 < 0.01
    (alpha = roughness^2, so roughness below 0.316: a plastic's coat, a
    carpaint's coat, base or flakes). Its pdf holds that lobe whichever
    lobe was sampled, and there D's denominator
    1 - cos^2 (1 - alpha^2) cancels, so the one-ulp differences of XLA's
    approximate rsqrt, sin and cos in the sampled half vector move D by up
    to ~1e-3 (measured 2.14e-3 at coat roughness 0.15, 4.4e-4 on the
    carpaint row at 0.2-0.25);
  - a grazing lane, |cos(n, wo)| < 0.02, where the cosines in the lobes'
    denominators amplify an ulp (measured 5.3e-5, on a rough carpaint
    lane at cos 0.011);
- ``evaluate_bsdf``: values and pdfs the same way (measured 7.2e-6, and
  9.1e-5 on the loose lanes), ``is_bssrdf`` exact;
- ``environment_lighting_roughness``: exact;
- the carpaint hash ``_hash3``: bit for bit on 2e5 points (the FMA
  placement of the jitted reference); ``flake_normal`` within 5e-7
  (measured 1.8e-7);
- the BSSRDF exit-point next origin against the integrator's expression
  (``integrator.py:588-601``) jitted: within ``POS_ULP`` = 2.5e-7, one ulp
  of the points' scale (|x| < 2.1), and bit-exact on more than 97 % of the
  lanes (measured 98.7 %; the rest differ where XLA's rsqrt moves the
  normalised exit normal or direction by an ulp). All three offsets are
  FMAs, as XLA:CPU contracts them (unfused, 97.5 % are exact);
- ``convert``: every plastic, carpaint and subsurface field of
  ``MaterialsSoA`` and the ``sss_mode``/``sss_max_steps`` of
  ``StaticConfig`` carried across exactly;
- ``sample_sss_random_walk`` against the JAX one on a triangle icosphere
  (the walk traces the scene at each of its 32 steps): the state after
  the walk, the exit flag, the lobe and the validity exact (the state
  holds every draw of every step, so it follows each scatter-or-boundary
  decision), the coat lobe's values within ``WALK_RTOL`` = 1e-3 (GGX at
  coat roughness 0.3). The reference's walk never leaves the object: it
  takes a boundary as total internal reflection when cos(-d, outward) <= 0,
  and from inside, heading out, that cosine is always negative
  (``sss.py:364-365``); the port reproduces this, so on both sides the
  walk lanes end invalid and keep their BSDF sample.
"""

import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metal_pathtracer_tpu import constants as JC
from metal_pathtracer_tpu.ops import bsdf as jbsdf
from metal_pathtracer_tpu.ops import carpaint as jcarpaint
from metal_pathtracer_tpu.ops import sss as jsss
from metal_pathtracer_tpu.ops.camera import build_camera as jax_camera
from metal_pathtracer_tpu.ops.vecmath import safe_normalize as jsafe
from metal_pathtracer_tpu.schema import settings_to_static as jax_static
from metal_pathtracer_tpu.schema import settings_to_uniforms as jax_uniforms
from metal_pathtracer_tpu.scene.resources import Material as JMaterial
from metal_pathtracer_tpu.scene.resources import Mesh as JMesh
from metal_pathtracer_tpu.scene.resources import SceneResources as JResources
from metal_pathtracer_tpu.settings import RenderSettings as JSettings
from metal_pathtracer_tpu_torch import constants as C
from metal_pathtracer_tpu_torch import convert
from metal_pathtracer_tpu_torch.ops import bsdf, carpaint, sss
from metal_pathtracer_tpu_torch.scene.resources import (
    Material,
    SceneResources,
)
from metal_pathtracer_tpu_torch.schema import (
    settings_to_static,
    settings_to_uniforms,
)
from metal_pathtracer_tpu_torch.settings import RenderSettings, SssMode
from metal_pathtracer_tpu_torch.utils.benchscene import (
    ICOSPHERE_ROWS,
    _ground_mesh,
    _sphere_mesh,
)

N = 8192
RTOL = 4e-5
DIR_ATOL = 32 * 2.0 ** -23
POS_ATOL = 1e-6
POS_ULP = 2.5e-7
LOOSE_RTOL = 6.5e-3
LOOSE_DIR_ATOL = 8e-5
WALK_RTOL = 1e-3

MATERIALS = [
    ICOSPHERE_ROWS["plastic"],
    dict(mat_type=C.MATERIAL_PLASTIC, base_color=(0.1, 0.4, 0.7),
         coat_roughness=0.5, ior=1.6),
    ICOSPHERE_ROWS["carpaint"],
    dict(mat_type=C.MATERIAL_CARPAINT, base_color=(0.1, 0.2, 0.6),
         coat_roughness=0.5, carpaint_base_metallic=0.7,
         carpaint_base_roughness=0.6, carpaint_flake_sample_weight=0.15,
         carpaint_flake_roughness=0.5, carpaint_flake_scale=6.0,
         carpaint_flake_anisotropy=0.3, carpaint_flake_normal_strength=0.4,
         carpaint_base_eta=(1.2, 0.9, 0.6), carpaint_base_k=(3.0, 2.5, 2.0),
         ior=1.5),
    ICOSPHERE_ROWS["sss"],
    dict(mat_type=C.MATERIAL_SUBSURFACE, base_color=(0.9, 0.5, 0.35),
         sss_mfp=0.4, sss_coat=True, coat_tint=(0.9, 0.8, 0.8),
         coat_roughness=0.3, sss_sigma_a=(0.5, 1.0, 2.0),
         sss_sigma_s=(4.0, 3.0, 2.0), sss_sigma_override=True),
    dict(mat_type=C.MATERIAL_SUBSURFACE, base_color=(0.7, 0.7, 0.6),
         sss_mfp=0.3, sss_method=1),
]
TYPES = (C.MATERIAL_PLASTIC, C.MATERIAL_SUBSURFACE, C.MATERIAL_CARPAINT)


def _unit(rng, n):
    v = rng.normal(size=(n, 3))
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


@pytest.fixture(scope="module")
def lanes():
    jr, pr = JResources(), SceneResources()
    for kw in MATERIALS:
        jr.add_material(JMaterial(**kw))
        pr.add_material(Material(**kw))
    settings = RenderSettings()
    rng = np.random.default_rng(29)
    idx = rng.integers(0, len(MATERIALS), N).astype(np.int32)
    normal = _unit(rng, N)
    incident = _unit(rng, N)
    flip = ((incident * normal).sum(-1) > 0.0) & (rng.random(N) < 0.85)
    incident[flip] *= -1.0
    return dict(
        jsoa=jr.build_materials_soa(), psoa=pr.build_materials_soa("cpu"),
        jm=jbsdf.gather_material(jr.build_materials_soa(), jnp.asarray(idx)),
        pm=bsdf.gather_material(pr.build_materials_soa("cpu"),
                                torch.tensor(idx)),
        jclamp=jbsdf.make_clamp_params(
            jax_uniforms(JSettings(), jax_camera(JSettings(), 8, 8), 0, 0)),
        pclamp=bsdf.make_clamp_params(
            settings_to_uniforms(settings, None, 0, 0)),
        idx=idx, normal=normal, incident=incident,
        position=rng.uniform(-1.5, 1.5, (N, 3)).astype(np.float32),
        wi=_unit(rng, N),
        state=rng.integers(0, 2 ** 32, N, dtype=np.uint64).astype(np.uint32))


def _loose(L):
    """The ill-conditioned lanes (see the module docstring): a plastic or
    carpaint material with a GGX lobe at alpha^2 < 0.01, or a grazing
    view, |cos(n, wo)| < 0.02."""
    def rough(kw):
        m = Material(**kw)
        if m.mat_type == C.MATERIAL_PLASTIC:
            return m.coat_roughness
        if m.mat_type == C.MATERIAL_CARPAINT:
            return min(m.coat_roughness, m.carpaint_base_roughness,
                       m.carpaint_flake_roughness)
        return 1.0

    alpha = np.array([rough(kw) for kw in MATERIALS])[L["idx"]] ** 2
    cos_o = np.abs((L["normal"] * L["incident"]).sum(-1))
    return (alpha * alpha < 0.01) | (cos_o < 0.02)


def _close(got, ref, loose, rtol=RTOL, atol=1e-6, loose_rtol=LOOSE_RTOL,
           loose_atol=1e-6):
    """``got`` against ``ref`` lane by lane: ``loose`` (a lane mask) lanes
    within the loose tolerances."""
    got, ref = np.asarray(got), np.asarray(ref)
    np.testing.assert_allclose(got[~loose], ref[~loose], rtol=rtol,
                               atol=atol)
    np.testing.assert_allclose(got[loose], ref[loose], rtol=loose_rtol,
                               atol=loose_atol)


@pytest.mark.parametrize("sss_mode", [SssMode.OFF, SssMode.SEPARABLE])
def test_zoo_sample_matches_jax(lanes, sss_mode):
    L = lanes
    n, inc, pos = L["normal"], L["incident"], L["position"]
    f = jax.jit(lambda m, st: jbsdf.sample_bsdf(
        m, jnp.asarray(pos), jnp.asarray(n), jnp.asarray(-inc),
        jnp.asarray(inc), jnp.ones(N, bool), st, L["jclamp"], int(sss_mode),
        jnp.ones(N), False, TYPES))
    js, jsmp = f(L["jm"], jnp.asarray(L["state"]))
    ps, psmp = bsdf.sample_bsdf(
        L["pm"], torch.tensor(n), torch.tensor(-inc), torch.tensor(inc),
        torch.ones(N, dtype=torch.bool),
        torch.tensor(L["state"].astype(np.int64)), L["pclamp"],
        torch.ones(N), TYPES, position=torch.tensor(pos),
        sss_mode=int(sss_mode))
    np.testing.assert_array_equal(ps.numpy().astype(np.uint32),
                                  np.asarray(js))
    for fld in ("is_delta", "medium_event", "lobe_type", "is_bssrdf",
                "has_exit_point"):
        np.testing.assert_array_equal(getattr(psmp, fld).numpy(),
                                      np.asarray(getattr(jsmp, fld)),
                                      err_msg=fld)
    ok = np.asarray(jsmp.pdf) > 0
    np.testing.assert_array_equal(psmp.pdf.numpy() > 0, ok)
    assert ok.mean() > 0.8
    loose = _loose(L)[ok]
    _close(psmp.direction.numpy()[ok], np.asarray(jsmp.direction)[ok],
           loose, rtol=0, atol=DIR_ATOL, loose_rtol=0,
           loose_atol=LOOSE_DIR_ATOL)
    for fld in ("weight", "pdf", "directional_pdf", "lobe_roughness"):
        _close(getattr(psmp, fld).numpy()[ok],
               np.asarray(getattr(jsmp, fld))[ok], loose)
    ex = np.asarray(jsmp.has_exit_point)
    if sss_mode == SssMode.SEPARABLE:
        assert ex.sum() > 100
    np.testing.assert_allclose(psmp.exit_point.numpy()[ex],
                               np.asarray(jsmp.exit_point)[ex], rtol=0,
                               atol=POS_ATOL)


def test_zoo_evaluate_matches_jax(lanes):
    L = lanes
    n, inc, pos, wi = L["normal"], L["incident"], L["position"], L["wi"]
    f = jax.jit(lambda m: jbsdf.evaluate_bsdf(
        m, jnp.asarray(pos), jnp.asarray(n), jnp.asarray(-inc),
        jnp.asarray(wi), L["jclamp"], 1, jnp.ones(N), False, TYPES))
    jev = f(L["jm"])
    pev = bsdf.evaluate_bsdf(L["pm"], torch.tensor(n), torch.tensor(-inc),
                             torch.tensor(wi), L["pclamp"], torch.ones(N),
                             TYPES, position=torch.tensor(pos))
    np.testing.assert_array_equal(pev.is_bssrdf.numpy(),
                                  np.asarray(jev.is_bssrdf))
    np.testing.assert_array_equal(pev.is_delta.numpy(),
                                  np.asarray(jev.is_delta))
    np.testing.assert_array_equal(pev.pdf.numpy() > 0,
                                  np.asarray(jev.pdf) > 0)
    assert (np.asarray(jev.pdf) > 0).mean() > 0.2
    loose = _loose(L)
    _close(pev.value.numpy(), jev.value, loose)
    _close(pev.pdf.numpy(), jev.pdf, loose)


def test_environment_lighting_roughness(lanes):
    L = lanes
    np.testing.assert_array_equal(
        bsdf.environment_lighting_roughness(L["pm"]).numpy(),
        np.asarray(jax.jit(jbsdf.environment_lighting_roughness)(L["jm"])))


def test_carpaint_hash_and_flake_normal(lanes):
    rng = np.random.default_rng(5)
    p = (rng.uniform(-3.0, 3.0, (200_000, 3))
         * rng.choice([1.0, 8.0, 2000.0], (200_000, 1))).astype(np.float32)
    ref = np.asarray(jax.jit(jcarpaint._hash3)(p))
    got = carpaint._hash3(torch.tensor(p)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))
    L = lanes
    n, pos = L["normal"], L["position"]
    ref = np.asarray(jax.jit(jcarpaint.flake_normal)(L["jm"], pos, n))
    got = carpaint.flake_normal(L["pm"], torch.tensor(pos),
                                torch.tensor(n)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=5e-7)


def _jax_exit_origin(smp_dir, exit_point, exit_normal, n_faced):
    """The BSSRDF next-origin expression of ``integrator.py:588-601``."""
    from metal_pathtracer_tpu.ops.vecmath import dot as jdot
    bad = ~jnp.all(jnp.isfinite(exit_normal), -1) \
        | (jdot(exit_normal, exit_normal) <= 0.0)
    en = jsafe(jnp.where(bad[..., None], n_faced, exit_normal))
    sign = jnp.where(jdot(smp_dir, en) >= 0.0, 1.0, -1.0)
    o = exit_point + en * (sign * JC.RAY_ORIGIN_EPSILON)[..., None]
    o = o + en * (JC.RAY_ORIGIN_EPSILON * 32.0)
    return o + jsafe(smp_dir) * (JC.RAY_ORIGIN_EPSILON * 32.0)


def test_exit_point_origin(lanes):
    L = lanes
    rng = np.random.default_rng(11)
    d, en, nf = L["wi"], L["normal"], L["incident"]
    en[::17] = 0.0                       # the faced-normal fallback
    pt = rng.uniform(-2.0, 2.0, (N, 3)).astype(np.float32)
    ref = np.asarray(jax.jit(_jax_exit_origin)(d, pt, en, nf))
    smp = bsdf.BsdfSample.invalid((N,), "cpu").replace(
        direction=torch.tensor(d), exit_point=torch.tensor(pt),
        exit_normal=torch.tensor(en))
    got = sss.exit_point_origin(smp, torch.tensor(nf)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=POS_ULP)
    assert (got == ref).all(-1).mean() > 0.97


def test_convert_carries_zoo_fields():
    """Every plastic, carpaint and subsurface field of the JAX package's
    ``MaterialsSoA`` and the subsurface fields of its ``StaticConfig``
    reach the port unchanged."""
    jr = JResources()
    for kw in MATERIALS:
        jr.add_material(JMaterial(**kw))
    soa = jr.build_materials_soa()
    d = {"materials": {f.name: np.asarray(getattr(soa, f.name))
                       for f in dataclasses.fields(soa)}}
    pm = convert.scene_arrays(dict(d, spheres=None, triangles=None,
                                   tri_bvh=None, rects=None), "cpu").materials
    names = [f.name for f in dataclasses.fields(soa)
             if f.name.startswith(("coat_", "carpaint_", "sss_"))]
    assert len(names) >= 25
    for name in names:
        np.testing.assert_array_equal(getattr(pm, name).numpy(),
                                      d["materials"][name], err_msg=name)
    js = JSettings()
    js.sssMode = SssMode.RANDOM_WALK
    js.sssMaxSteps = 12
    st = convert.static_config(dataclasses.asdict(jax_static(js, 8, 8, [5])))
    assert (st.sss_mode, st.sss_max_steps) == (2, 12)
    ps = RenderSettings()
    ps.sssMode, ps.sssMaxSteps = SssMode.RANDOM_WALK, 12
    assert st == settings_to_static(ps, 8, 8, [5])


def _walk_scene():
    """A random-walk subsurface icosphere (subdivision 2) on the ground
    quad, both packages: (JAX arrays, port arrays)."""
    kw = dict(ICOSPHERE_ROWS["sss"], sss_method=1, coat_roughness=0.3)
    jr, pr = JResources(), SceneResources()
    meshes = [_sphere_mesh(2, (0.0, 0.6, 0.0), 0.8, 0, "sss"),
              _ground_mesh(1)]
    for res, mat, mesh in ((jr, JMaterial, JMesh), (pr, Material, None)):
        res.add_material(mat(**kw))
        res.add_material(mat(base_color=(0.6, 0.6, 0.6)))
        for m in meshes:
            res.add_mesh(m if mesh is None else mesh(**{
                k: getattr(m, k) for k in ("name", "vertices", "normals",
                                           "uv0", "uv1", "tangents",
                                           "indices", "material")}))
    return jr.build_arrays(), pr.build_arrays(device="cpu")


def test_random_walk_matches_jax():
    from metal_pathtracer_tpu.ops import intersect as jintersect
    from metal_pathtracer_tpu_torch.ops import intersect

    jscene, pscene = _walk_scene()
    rng = np.random.default_rng(3)
    n = 2048
    # rays from the camera side aimed at the sphere
    target = (_unit(rng, n) * 0.8 + np.array([0.0, 0.6, 0.0])).astype(
        np.float32)
    origin = (target + _unit(rng, n) * 3.0).astype(np.float32)
    d = target - origin
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    jrec = jax.jit(lambda o, d: jintersect.trace_scene(
        o, d, jscene, JC.EPSILON_T, JC.INFINITY_T))(origin, d)
    prec = intersect.trace_scene(torch.tensor(origin), torch.tensor(d),
                                 pscene, C.EPSILON_T, C.INFINITY_T)
    front = np.asarray(jrec.front_face) & (np.asarray(jrec.material) == 0)
    assert front.sum() > 500
    np.testing.assert_array_equal(prec.point.numpy(), np.asarray(jrec.point))
    state = rng.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)
    jm = jbsdf.gather_material(jscene.materials, jrec.material)
    jclamp = jbsdf.make_clamp_params(
        jax_uniforms(JSettings(), jax_camera(JSettings(), 8, 8), 0, 0))
    jinc = jnp.asarray(d)
    jrec_w = SimpleNamespace(normal=jrec.normal, point=jrec.point,
                             front_face=jnp.asarray(front))
    js, jsmp = jax.jit(lambda st: jsss.sample_sss_random_walk(
        jscene, jm, jrec_w, -jinc, jinc, st, jclamp, 32))(state)
    pm = bsdf.gather_material(pscene.materials, prec.material)
    pinc = torch.tensor(d)
    prec_w = SimpleNamespace(normal=prec.normal, point=prec.point,
                             front_face=torch.tensor(front))
    ps, psmp = sss.sample_sss_random_walk(
        pscene, pm, prec_w, -pinc, pinc,
        torch.tensor(state.astype(np.int64)),
        bsdf.make_clamp_params(settings_to_uniforms(RenderSettings(), None,
                                                    0, 0)), 32)
    np.testing.assert_array_equal(ps.numpy().astype(np.uint32),
                                  np.asarray(js))
    for fld in ("has_exit_point", "is_bssrdf", "lobe_type"):
        np.testing.assert_array_equal(getattr(psmp, fld).numpy(),
                                      np.asarray(getattr(jsmp, fld)),
                                      err_msg=fld)
    ok = np.asarray(jsmp.pdf) > 0
    np.testing.assert_array_equal(psmp.pdf.numpy() > 0, ok)
    coat = ok & (np.asarray(jsmp.lobe_type) == 1)
    assert coat.sum() > 100 and (front & ~coat).sum() > 500
    for fld in ("direction", "weight", "pdf", "directional_pdf"):
        np.testing.assert_allclose(getattr(psmp, fld).numpy()[ok],
                                   np.asarray(getattr(jsmp, fld))[ok],
                                   rtol=WALK_RTOL, atol=1e-6, err_msg=fld)

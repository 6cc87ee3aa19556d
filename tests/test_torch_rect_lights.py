"""Metal, diffuse lights and rect-light NEE, module by module, against the
JAX package (its XLA functions, jitted as the render runs them), on the
same inputs made from a numpy seed:

- metal sampling (``bsdf._sample_metal``) and evaluation
  (``evaluate_bsdf``'s metal branch) at a mirror (roughness 0, a delta
  lobe), a rough lobe (0.3) and a conductor with its own eta and k: RNG
  states, validity and the delta flag exactly, directions and values
  within the stated bounds; the Cornell box's glossy mirror (0.02)
  against the JAX package in float64;
- the rect-light sample from three uniforms
  (``integrator._rect_light_sample_from_uniforms``), the light pdf of a
  hit for emissive-hit MIS (``_rect_light_pdf_for_hit``) and the
  spec-NEE chain's light hit (``specnee._rect_hit_light``) on the Cornell
  box, and the sample and the chain's hit again with ``emitEnv=1`` on the
  lamp under an environment map, where the lamp's emission is scaled by
  the environment seen along its reversed normal;
- what the port still refuses: MNEE (ROADMAP Queue 1) and instances (step
  14); environment-modulated lights and the plastic, subsurface and
  carpaint materials pass.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metal_pathtracer_tpu import constants as JC
from metal_pathtracer_tpu.ops import bsdf as jax_bsdf
from metal_pathtracer_tpu.ops import integrator as jax_integrator
from metal_pathtracer_tpu.ops import intersect as jax_intersect
from metal_pathtracer_tpu.ops import specnee as jax_specnee
from metal_pathtracer_tpu.scene import dsl as jax_dsl
from metal_pathtracer_tpu.scene.resources import Material as JMaterial
from metal_pathtracer_tpu.scene.resources import SceneResources as JResources
from metal_pathtracer_tpu.schema import settings_to_static as jax_static
from metal_pathtracer_tpu.schema import settings_to_uniforms as jax_uniforms
from metal_pathtracer_tpu.settings import RenderSettings as JSettings
from metal_pathtracer_tpu_torch import constants as C
from metal_pathtracer_tpu_torch.ops import bsdf, integrator, intersect
from metal_pathtracer_tpu_torch.ops import env as env_ops
from metal_pathtracer_tpu_torch.ops import specnee
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
from metal_pathtracer_tpu_torch.utils import benchscene as B
from metal_pathtracer_tpu_torch.utils import procgen
from metal_pathtracer_tpu_torch.utils.benchscene import cornell_scene_text

N = 4000

METALS = {
    "mirror": dict(base_color=(0.95, 0.9, 0.8), roughness=0.0),
    "rough": dict(base_color=(0.9, 0.7, 0.4), roughness=0.3),
    "conductor": dict(base_color=(0.9, 0.9, 0.9), roughness=0.3,
                      conductor_eta=(0.2, 0.92, 1.1),
                      conductor_k=(3.9, 2.45, 2.14), has_conductor=True),
}


#: the Cornell box's mirror (``assets/scenes/cornell.scene``): GGX at
#: alpha 4e-4, where float32 is ill-conditioned (see the test)
GLOSSY = dict(base_color=(0.95, 0.95, 0.95), roughness=0.02)


@pytest.fixture(autouse=True)
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _metal_lanes(kind):
    kw = dict(mat_type=C.MATERIAL_METAL,
              **(GLOSSY if kind == "glossy" else METALS[kind]))
    jr, pr = JResources(), SceneResources()
    jr.add_material(JMaterial(**kw))
    pr.add_material(Material(**kw))
    jm = jax_bsdf.gather_material(jr.build_materials_soa(),
                                  jnp.zeros(N, jnp.int32))
    pm = bsdf.gather_material(pr.build_materials_soa("cpu"),
                              torch.zeros(N, dtype=torch.long))
    return jm, pm


def _directions(seed=11):
    """Unit normals away from the ONB's pole (n.z > -0.9, where the
    basis divides by 1 + n.z) and outgoing directions above them."""
    rng = np.random.default_rng(seed)
    n = rng.normal(size=(N, 3)).astype(np.float32)
    n[:, 2] = np.abs(n[:, 2])
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    wo = rng.normal(size=(N, 3)).astype(np.float32)
    wo /= np.linalg.norm(wo, axis=-1, keepdims=True)
    wo = np.where((np.sum(wo * n, -1) < 0.05)[:, None], -wo, wo)
    wo = wo.astype(np.float32)
    state = rng.integers(0, 2 ** 32, N, dtype=np.uint64)
    return n, wo, state


def _clamps():
    return (jax_bsdf.make_clamp_params(jax_uniforms(JSettings(), None, 0, 0)),
            bsdf.make_clamp_params(settings_to_uniforms(RenderSettings(),
                                                        None, 0, 0)))


@pytest.mark.parametrize("kind", sorted(METALS))
def test_metal_sample_matches_jax(kind):
    """States, validity, the delta flag and the lobe exactly; directions
    within 1e-5 (VNDF sampling's sqrt(1 - p1^2) and XLA's cos/sin of the
    sampled angle scale an ulp into ~50 on 0.3 % of the lanes; the rest
    agree within 2e-6); weights and pdfs within 1e-3 relative (GGX at
    roughness 0.3: D and G of a half vector that differs by an ulp)."""
    jm, pm = _metal_lanes(kind)
    n, wo, state = _directions()
    jcp, pcp = _clamps()
    js, jo = jax.jit(lambda n, wo, s: jax_bsdf._sample_metal(
        jm, n, wo, -wo, s, jcp))(n, wo, state.astype(np.uint32))
    ps, po = bsdf._sample_metal(pm, torch.from_numpy(n), torch.from_numpy(wo),
                                torch.from_numpy(-wo),
                                torch.from_numpy(state.astype(np.int64)), pcp)
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js).astype(np.int64))
    valid = np.asarray(jo.pdf) > 0.0
    np.testing.assert_array_equal(po.pdf.numpy() > 0.0, valid)
    np.testing.assert_array_equal(po.is_delta.numpy(), np.asarray(jo.is_delta))
    np.testing.assert_array_equal(po.lobe_type.numpy(),
                                  np.asarray(jo.lobe_type))
    assert valid.mean() > 0.9
    assert po.is_delta.numpy()[valid].all() == (kind == "mirror")
    np.testing.assert_allclose(po.direction.numpy()[valid],
                               np.asarray(jo.direction)[valid], atol=1e-5)
    close = np.abs(po.direction.numpy() - np.asarray(jo.direction)).max(-1)
    assert (close[valid] <= 2e-6).mean() > 0.99
    for f in ("weight", "pdf"):
        got, want = getattr(po, f).numpy()[valid], \
            np.asarray(getattr(jo, f))[valid]
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-6,
                                   err_msg=f)


@pytest.mark.parametrize("kind", sorted(METALS))
def test_metal_evaluate_matches_jax(kind):
    """``evaluate_bsdf`` on metal lanes: the delta flag exactly (a mirror
    has no value to add), values and pdfs within 1e-3 relative."""
    jm, pm = _metal_lanes(kind)
    n, wo, _ = _directions(13)
    rng = np.random.default_rng(17)
    wi = rng.normal(size=(N, 3)).astype(np.float32)
    wi /= np.linalg.norm(wi, axis=-1, keepdims=True)
    wi = np.where((np.sum(wi * n, -1) < 0)[:, None], -wi, wi)
    # half the lanes near the mirror direction, where the lobe is
    refl = 2.0 * np.sum(wo * n, -1, keepdims=True) * n - wo
    wi[::2] = refl[::2] + 0.2 * wi[::2]
    wi = (wi / np.linalg.norm(wi, axis=-1, keepdims=True)).astype(np.float32)
    jcp, pcp = _clamps()
    ref = jax.jit(lambda n, wo, wi: jax_bsdf.evaluate_bsdf(
        jm, jnp.zeros_like(n), n, wo, wi, jcp, 0, jnp.ones(N), False,
        (C.MATERIAL_METAL,)))(n, wo, wi)
    got = bsdf.evaluate_bsdf(pm, torch.from_numpy(n), torch.from_numpy(wo),
                             torch.from_numpy(wi), pcp, torch.ones(N),
                             (C.MATERIAL_METAL,))
    np.testing.assert_array_equal(got.is_delta.numpy(),
                                  np.asarray(ref.is_delta))
    np.testing.assert_allclose(got.value.numpy(), np.asarray(ref.value),
                               rtol=1e-3, atol=1e-6)
    np.testing.assert_allclose(got.pdf.numpy(), np.asarray(ref.pdf),
                               rtol=1e-3, atol=1e-6)
    if kind != "mirror":
        assert (np.asarray(ref.pdf) > 0).mean() > 0.3


def _float64(tree):
    """A JAX pytree with its float32 leaves as float64 (inside
    ``jax.enable_x64``)."""
    return jax.tree_util.tree_map(
        lambda a: jnp.asarray(np.asarray(a), jnp.float64)
        if np.asarray(a).dtype == np.float32 else jnp.asarray(np.asarray(a)),
        tree)


def _rel(a, b):
    return (np.abs(a - b).reshape(len(a), -1).max(-1)
            / np.maximum(np.abs(b).reshape(len(b), -1).max(-1), 1e-30))


def test_glossy_metal_matches_float64_jax():
    """The Cornell mirror's lobe (roughness 0.02, alpha 4e-4) against the
    JAX package's own functions run in float64, the second witness where
    float32 cannot agree lane for lane: D's denominator is a few ulps of
    cos_h^2 near 1, so an ulp in a half vector moves D by up to 47 %.

    - Evaluation (NEE's ``evaluate_bsdf``) on directions 0.005-0.2 rad
      off the mirror direction: the port's mean error against float64 is
      within 1.25x the JAX package's own float32 error (measured 1.08x,
      1.06x and 1.06x in the three bands; a Fresnel 20 % low or an alpha
      twice too large is 10^2-10^4 times worse).
    - Sampling: states, validity, the delta flag and the lobe equal the
      float32 JAX sample; directions within 1e-5 of float64; the median
      sample weight within 10 % of float64's (measured +7.9 %; a Fresnel
      20 % low gives -14 %). The weight is a ratio of D at the sampled and
      at the recomputed half vector: lane for lane the port's is further
      from float64 than the JAX package's (median 40 % against 6 %,
      measured), which XLA's rounding keeps correlated; the median holds.
    """
    jm, pm = _metal_lanes("glossy")
    n, wo, state = _directions(13)
    rng = np.random.default_rng(17)
    refl = 2.0 * np.sum(wo * n, -1, keepdims=True) * n - wo
    t = rng.normal(size=(N, 3)).astype(np.float32)
    t -= np.sum(t * refl, -1, keepdims=True) * refl
    t /= np.linalg.norm(t, axis=-1, keepdims=True)
    ang = np.exp(rng.uniform(np.log(5e-3), np.log(0.2), N))
    wi = refl * np.cos(ang)[:, None] + t * np.sin(ang)[:, None]
    wi = (wi / np.linalg.norm(wi, axis=-1, keepdims=True)).astype(np.float32)
    jcp, pcp = _clamps()

    def evaluate(m, ones):
        return jax.jit(lambda n, wo, wi: jax_bsdf.evaluate_bsdf(
            m, jnp.zeros_like(n), n, wo, wi, jcp, 0, ones, False,
            (C.MATERIAL_METAL,)))

    def sample(m):
        return jax.jit(lambda n, wo, s: jax_bsdf._sample_metal(
            m, n, wo, -wo, s, jcp))

    ev32 = evaluate(jm, jnp.ones(N))(n, wo, wi)
    js, jo = sample(jm)(n, wo, state.astype(np.uint32))
    with jax.enable_x64():
        jm64 = _float64(jm)
        f64 = lambda x: x.astype(np.float64)
        ev64 = evaluate(jm64, jnp.ones(N, jnp.float64))(f64(n), f64(wo),
                                                         f64(wi))
        _, jo64 = sample(jm64)(f64(n), f64(wo), state.astype(np.uint32))
        ev64, jo64 = jax.tree_util.tree_map(np.asarray, (ev64, jo64))
    got = bsdf.evaluate_bsdf(pm, torch.from_numpy(n), torch.from_numpy(wo),
                             torch.from_numpy(wi), pcp, torch.ones(N),
                             (C.MATERIAL_METAL,))
    ok = np.asarray(ev32.pdf) > 0.0
    assert ok.mean() > 0.9
    for lo, hi in ((5e-3, 1e-2), (1e-2, 3e-2), (3e-2, 0.2)):
        band = ok & (ang >= lo) & (ang < hi)
        for f in ("value", "pdf"):
            e_port = _rel(getattr(got, f).numpy()[band],
                          getattr(ev64, f)[band]).mean()
            e_jax = _rel(np.asarray(getattr(ev32, f))[band],
                         getattr(ev64, f)[band]).mean()
            assert e_port <= 1.25 * e_jax + 1e-6, (lo, f, e_port, e_jax)

    ps, po = bsdf._sample_metal(pm, torch.from_numpy(n), torch.from_numpy(wo),
                                torch.from_numpy(-wo),
                                torch.from_numpy(state.astype(np.int64)), pcp)
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js).astype(np.int64))
    valid = np.asarray(jo.pdf) > 0.0
    np.testing.assert_array_equal(po.pdf.numpy() > 0.0, valid)
    np.testing.assert_array_equal(jo64.pdf > 0.0, valid)
    np.testing.assert_array_equal(po.is_delta.numpy(), np.asarray(jo.is_delta))
    np.testing.assert_array_equal(po.lobe_type.numpy(),
                                  np.asarray(jo.lobe_type))
    assert valid.mean() > 0.9 and not po.is_delta.numpy().any()
    np.testing.assert_allclose(po.direction.numpy()[valid],
                               jo64.direction[valid], atol=1e-5)
    w_port = np.median(po.weight.numpy()[valid], 0)
    w_64 = np.median(jo64.weight[valid], 0)
    np.testing.assert_allclose(w_port, w_64, rtol=0.1)


@pytest.fixture(scope="module")
def cornell():
    """The Cornell box in both packages, hits of rays from inside it, and
    three uniforms per lane."""
    js, jr = JSettings(), JResources()
    jax_dsl.parse_scene(cornell_scene_text(), js, jr)
    ps, pr = RenderSettings(), SceneResources()
    dsl.parse_scene(cornell_scene_text(), ps, pr)
    jscene, pscene = jr.build_arrays(), pr.build_arrays(device="cpu")
    rng = np.random.default_rng(21)
    o = rng.uniform([-0.95, 0.05, -0.95], [0.95, 1.95, 0.95],
                    (N, 3)).astype(np.float32)
    d = rng.normal(size=(N, 3)).astype(np.float32)
    d[::3, 1] = np.abs(d[::3, 1]) + 2.0     # a third aimed at the ceiling
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    u = rng.random((3, N)).astype(np.float32)
    return dict(js=js, jscene=jscene, ps=ps, pscene=pscene, o=o, d=d, u=u)


def test_rect_light_sample_matches_jax(cornell):
    """The light sample from three uniforms: validity, the chosen light's
    emission exactly; direction, distance and pdf within 1e-5 relative
    (the sample point's FMA placement is XLA's: x and y unfused, z as two
    FMAs)."""
    c = cornell
    js, jscene, pscene, u = c["js"], c["jscene"], c["pscene"], c["u"]
    o = c["o"].copy()
    o[::4, 1] = 2.2     # above the one-sided light: no sample
    static = jax_static(js, 8, 8, [0, 1, 2, 3])
    uni = jax_uniforms(js, None, 0, 0)
    ref = jax.jit(lambda p, a, b, e: jax_integrator.
                  _rect_light_sample_from_uniforms(jscene, p, a, b, e,
                                                   static, uni))(
        o, u[0], u[1], u[2])
    ps = c["ps"]
    got = integrator.rect_light_sample_from_uniforms(
        pscene, torch.from_numpy(o), *(torch.from_numpy(x) for x in u),
        settings_to_uniforms(ps, None, 0, 0),
        settings_to_static(ps, 8, 8, [0, 1, 2, 3]))
    valid = np.asarray(ref[4])
    np.testing.assert_array_equal(got[4].numpy(), valid)
    assert 0.3 < valid.mean() < 1.0
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(ref[3]))
    for i, name in enumerate(("direction", "distance", "pdf")):
        np.testing.assert_allclose(got[i].numpy()[valid],
                                   np.asarray(ref[i])[valid], rtol=1e-5,
                                   atol=1e-7, err_msg=name)


def test_rect_light_pdf_and_chain_hit_match_jax(cornell):
    """The light pdf of each hit (emissive-hit MIS) and the spec-NEE
    chain's light hit over the same records: validity and emission
    exactly, pdfs within 1e-5 relative."""
    c = cornell
    jscene, pscene, o, d = c["jscene"], c["pscene"], c["o"], c["d"]
    rec_j = jax.jit(lambda o, d: jax_intersect.trace_scene(
        o, d, jscene, JC.EPSILON_T, JC.INFINITY_T))(o, d)
    rec_p = intersect.trace_scene(torch.from_numpy(o), torch.from_numpy(d),
                                  pscene, C.EPSILON_T, C.INFINITY_T)
    pdf_j = np.asarray(jax.jit(lambda r, o: jax_integrator.
                               _rect_light_pdf_for_hit(jscene, r, o))(
        rec_j, o))
    pdf_p = integrator.rect_light_pdf_for_hit(
        pscene, rec_p.point, rec_p.prim_type, rec_p.prim_index,
        torch.from_numpy(o)).numpy()
    np.testing.assert_array_equal(pdf_p > 0, pdf_j > 0)
    assert (pdf_j > 0).sum() > 100
    np.testing.assert_allclose(pdf_p, pdf_j, rtol=1e-5, atol=0)
    static = jax_static(c["js"], 8, 8, [0, 1, 2, 3])
    uni = jax_uniforms(c["js"], None, 0, 0)
    em_j, cpdf_j, ok_j = jax.jit(lambda r, o: jax_specnee._rect_hit_light(
        jscene, uni, static, r, o))(rec_j, o)
    em_p, cpdf_p, ok_p = specnee.rect_hit_light(
        pscene, settings_to_uniforms(c["ps"], None, 0, 0),
        settings_to_static(c["ps"], 8, 8, [0, 1, 2, 3]), rec_p,
        torch.from_numpy(o))
    ok = np.asarray(ok_j)
    np.testing.assert_array_equal(ok_p.numpy(), ok)
    np.testing.assert_array_equal(em_p.numpy()[ok], np.asarray(em_j)[ok])
    np.testing.assert_allclose(cpdf_p.numpy()[ok], np.asarray(cpdf_j)[ok],
                               rtol=1e-5)


def test_emission_env_light_matches_jax(cornell):
    """``emitEnv=1`` on the Cornell box's lamp under the toy environment
    map of ``test_torch_cornell_render.py``, both functions against the
    JAX package's jitted ones on the same rays and draws: the light
    sample's and the chain hit's validity and emission exactly, with the
    emission modulated on every valid lane (the sample scales it by the
    environment seen along the lamp's reversed normal; the chain hit does
    so on front faces, along the reversed shading normal); directions,
    distances and pdfs within 1e-5 relative."""
    from test_torch_cornell_render import _toy_env

    c = cornell
    penv, jenv = _toy_env()
    js, jr = JSettings(), JResources()
    jax_dsl.parse_scene(B.cornell_emitenv_text(), js, jr)
    ps, pr = RenderSettings(), SceneResources()
    dsl.parse_scene(B.cornell_emitenv_text(), ps, pr)
    assert pr.materials[3].emission_env
    js.backgroundMode = ps.backgroundMode = BackgroundMode.ENVIRONMENT
    jscene = jr.build_arrays(environment=jenv)
    pscene = pr.build_arrays(environment=penv, device="cpu")
    jstatic, juni = jax_static(js, 8, 8, [0, 1, 2, 3]), \
        jax_uniforms(js, None, 0, 0)
    pstatic, puni = settings_to_static(ps, 8, 8, [0, 1, 2, 3]), \
        settings_to_uniforms(ps, None, 0, 0)
    assert integrator.env_nee(pscene, pstatic)
    lamp = np.asarray(pscene.materials.emission[3])
    o, d, u = c["o"], c["d"], c["u"]

    ref = jax.jit(lambda p, a, b, e: jax_integrator.
                  _rect_light_sample_from_uniforms(jscene, p, a, b, e,
                                                   jstatic, juni))(
        o, u[0], u[1], u[2])
    got = integrator.rect_light_sample_from_uniforms(
        pscene, torch.from_numpy(o), *(torch.from_numpy(x) for x in u),
        puni, pstatic)
    valid = np.asarray(ref[4])
    np.testing.assert_array_equal(got[4].numpy(), valid)
    assert valid.mean() > 0.3
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(ref[3]))
    assert not np.isclose(got[3].numpy()[valid], lamp).all(-1).any()
    for i, name in enumerate(("direction", "distance", "pdf")):
        np.testing.assert_allclose(got[i].numpy()[valid],
                                   np.asarray(ref[i])[valid], rtol=1e-5,
                                   atol=1e-7, err_msg=name)

    rec_j = jax.jit(lambda o, d: jax_intersect.trace_scene(
        o, d, jscene, JC.EPSILON_T, JC.INFINITY_T))(o, d)
    rec_p = intersect.trace_scene(torch.from_numpy(o), torch.from_numpy(d),
                                  pscene, C.EPSILON_T, C.INFINITY_T)
    em_j, pdf_j, ok_j = jax.jit(lambda r, o: jax_specnee._rect_hit_light(
        jscene, juni, jstatic, r, o))(rec_j, o)
    em_p, pdf_p, ok_p = specnee.rect_hit_light(pscene, puni, pstatic, rec_p,
                                               torch.from_numpy(o))
    ok = np.asarray(ok_j)
    np.testing.assert_array_equal(ok_p.numpy(), ok)
    assert ok.sum() > 100
    np.testing.assert_array_equal(em_p.numpy()[ok], np.asarray(em_j)[ok])
    assert not np.isclose(em_p.numpy()[ok], lamp).all(-1).any()
    np.testing.assert_allclose(pdf_p.numpy()[ok], np.asarray(pdf_j)[ok],
                               rtol=1e-5)


def test_unported_light_paths_raise(cornell):
    """Env-modulated lights under an environment map, the plastic,
    subsurface and carpaint materials and MNEE are ported and pass; an
    instanced placement builds its group; the Cornell box and an env-lit
    scene with plain rect lights pass."""
    ps, pr = RenderSettings(), SceneResources()
    dsl.parse_scene(cornell_scene_text(), ps, pr)
    types = pr.material_types_present()
    assert integrator.rect_nee(cornell["pscene"])
    ps.enableMnee = True
    static = settings_to_static(ps, 8, 8, types)
    assert static.enable_mnee and static.enable_mnee_secondary
    ps.enableMnee = False
    # an instanced placement (ported) joins the box as its own group, ids
    # after the box's meshes, and the scene still passes
    verts, faces = procgen.icosphere(1)
    ball = Mesh("ball", (0.2 * verts).astype(np.float32),
                verts.astype(np.float32),
                np.zeros((len(verts), 2), np.float32),
                np.zeros((len(verts), 2), np.float32),
                np.zeros((len(verts), 4), np.float32), faces.astype(np.int32))
    tf = np.eye(4)
    tf[:3, 3] = [0.0, 0.3, 0.0]
    pr.add_mesh_instance(ball, tf, 1)
    placed = pr.build_arrays(device="cpu")
    (group,) = placed.instanced
    assert (group.count, group.base_id) == (1, len(pr.meshes))
    assert group.material.tolist() == [1]
    np.testing.assert_array_equal(group.triangles.v1.numpy(),
                                  ball.vertices[ball.indices[:, 1]])
    env = env_ops.environment_from_texels(np.ones((4, 8, 3), np.float32),
                                          "cpu")
    ps.backgroundMode = BackgroundMode.ENVIRONMENT
    lit = pr.build_arrays(environment=env, device="cpu")
    assert integrator.env_nee(lit, settings_to_static(ps, 8, 8, types))
    assert integrator.rect_nee(lit)
    pr.materials[3].emission_env = True
    lit = pr.build_arrays(environment=env, device="cpu")
    assert float(lit.materials.emission_env[3]) > 0.0

"""The port's BSDFs for this slice (dielectric, PBR, lambert) and its
any-hit trace vs the JAX package.

- ``sample_bsdf`` / ``evaluate_bsdf`` on 4,096 numpy lanes over the
  material rows of ``tests/test_fused_shade.py:436-444`` (metallic, rough
  and transmissive PBR) plus smooth PBR, dielectric and lambert: the RNG
  state after sampling, the lobe flags (delta, medium event, lobe type)
  and the validity of every sample exact; directions within 8 ulps of 1.0
  (measured 5, on a refraction near total internal reflection) and values
  within ``RTOL`` = 2e-5 relative (measured 1e-5), except on two kinds
  of ill-conditioned lane, which get ``LOOSE_DIR_ATOL`` = 1e-4 and
  ``LOOSE_RTOL`` = 1e-2 (measured 2.4e-5 and 7.2e-3): lanes that sampled
  a rough GGX lobe, whose half vector comes out of ~40 dependent ops (two
  sin/cos, three normalisations) that XLA:CPU contracts or approximates
  its own way, and where at roughness 0.1 (alpha 0.01) the
  distribution's denominator 1 - cos^2(1 - alpha^2) cancels to ~1e-4, so
  a 1-ulp change in the half vector moves D by ~1e-3; and grazing lanes
  (|cos| < 1e-3), where refraction weights divide by the cosine;
- the any-hit plain version vs the JAX package's ``trace_occluded`` on
  ``bench.py:136-146``'s probe set: flags equal, bit for bit.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metal_pathtracer_tpu import constants as JC
from metal_pathtracer_tpu.ops import bsdf as jbsdf
from metal_pathtracer_tpu.ops import intersect as jintersect
from metal_pathtracer_tpu.ops.camera import build_camera as jax_camera
from metal_pathtracer_tpu.schema import settings_to_uniforms as jax_uniforms
from metal_pathtracer_tpu.scene.resources import Material as JMaterial
from metal_pathtracer_tpu.scene.resources import SceneResources as JResources
from metal_pathtracer_tpu.settings import RenderSettings
from metal_pathtracer_tpu.utils.procgen import dragon_class_scene_mesh
from metal_pathtracer_tpu_torch import constants as C
from metal_pathtracer_tpu_torch.ops import bsdf
from metal_pathtracer_tpu_torch.ops.kernels import traverse
from metal_pathtracer_tpu_torch.scene.resources import (
    Material,
    Mesh,
    SceneResources,
)
from metal_pathtracer_tpu_torch.schema import settings_to_uniforms

N = 4096
RTOL = 2e-5
DIR_ATOL = 8 * 2.0 ** -23
LOOSE_RTOL = 1e-2
LOOSE_DIR_ATOL = 1e-4

MATERIALS = [
    dict(base_color=(0.6, 0.6, 0.6)),
    dict(mat_type=C.MATERIAL_PBR, base_color=(0.8, 0.3, 0.2), roughness=0.4,
         pbr_metallic=0.8),
    dict(mat_type=C.MATERIAL_PBR, base_color=(0.9, 0.9, 0.9), roughness=0.1,
         pbr_transmission=0.9, ior=1.5, pbr_thickness=0.3,
         dielectric_sigma_a=(0.5, 0.1, 0.1)),
    dict(mat_type=C.MATERIAL_PBR, base_color=(0.5, 0.7, 0.9), roughness=0.0,
         pbr_transmission=0.5, ior=1.4, pbr_metallic=0.1),
    dict(mat_type=C.MATERIAL_PBR, base_color=(1.0, 1.0, 1.0), roughness=0.35,
         pbr_metallic=0.15),
    dict(mat_type=C.MATERIAL_DIELECTRIC, ior=1.5,
         dielectric_sigma_a=(0.08, 0.02, 0.02)),
    dict(mat_type=C.MATERIAL_DIELECTRIC, ior=1.33, thin=True),
]
TYPES = (C.MATERIAL_LAMBERTIAN, C.MATERIAL_DIELECTRIC, C.MATERIAL_PBR)
CLAMPS = {"default": {},
          "tail": dict(specularTailClampBase=2.0,
                       specularTailClampRoughnessScale=4.0,
                       minSpecularPdf=0.05)}


def _unit(rng, n):
    v = rng.normal(size=(n, 3))
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


@pytest.fixture(scope="module", params=sorted(CLAMPS))
def lanes(request):
    return _lanes(request.param)


def _lanes(clamps: str):
    jr, pr = JResources(), SceneResources()
    for kw in MATERIALS:
        jr.add_material(JMaterial(**kw))
        pr.add_material(Material(**kw))
    settings = RenderSettings()
    for k, v in CLAMPS[clamps].items():
        setattr(settings, k, v)
    rng = np.random.default_rng(17)
    idx = rng.integers(0, len(MATERIALS), N).astype(np.int32)
    normal = _unit(rng, N)
    incident = _unit(rng, N)
    # most lanes see the front side, as a shading point does
    flip = (incident * normal).sum(-1) > 0.0
    flip &= rng.random(N) < 0.8
    incident[flip] *= -1.0
    return dict(
        jm=jbsdf.gather_material(jr.build_materials_soa(), jnp.asarray(idx)),
        pm=bsdf.gather_material(pr.build_materials_soa("cpu"),
                                torch.tensor(idx)),
        jclamp=jbsdf.make_clamp_params(
            jax_uniforms(settings, jax_camera(settings, 8, 8), 0, 0)),
        pclamp=bsdf.make_clamp_params(
            settings_to_uniforms(settings, None, 0, 0)),
        normal=normal, incident=incident,
        front=rng.random(N) < 0.7, wi=_unit(rng, N),
        state=rng.integers(0, 2 ** 32, N, dtype=np.uint64).astype(np.uint32))


def _close(got, ref, atol=1e-6, rtol=RTOL):
    np.testing.assert_allclose(got, np.asarray(ref), rtol=rtol, atol=atol)


def test_sample_bsdf_matches_jax(lanes):
    L = lanes
    n, inc = L["normal"], L["incident"]
    js, jsmp = jbsdf.sample_bsdf(
        L["jm"], jnp.zeros((N, 3)), jnp.asarray(n), jnp.asarray(-inc),
        jnp.asarray(inc), jnp.asarray(L["front"]), jnp.asarray(L["state"]),
        L["jclamp"], 0, jnp.ones(N), False, TYPES)
    ps, psmp = bsdf.sample_bsdf(
        L["pm"], torch.tensor(n), torch.tensor(-inc), torch.tensor(inc),
        torch.tensor(L["front"]), torch.tensor(L["state"].astype(np.int64)),
        L["pclamp"], torch.ones(N), TYPES)
    np.testing.assert_array_equal(ps.numpy().astype(np.uint32),
                                  np.asarray(js))
    for f in ("is_delta", "medium_event", "lobe_type"):
        np.testing.assert_array_equal(getattr(psmp, f).numpy(),
                                      np.asarray(getattr(jsmp, f)), err_msg=f)
    np.testing.assert_array_equal(psmp.pdf.numpy() > 0,
                                  np.asarray(jsmp.pdf) > 0)
    loose = (((np.asarray(L["jm"].mat_type) == C.MATERIAL_PBR)
              & (np.asarray(jsmp.lobe_type) > 0)
              & ~np.asarray(jsmp.is_delta))
             | (np.abs((n * inc).sum(-1)) < 1e-3))
    for lanes_, dir_atol, rtol in ((~loose, DIR_ATOL, RTOL),
                                   (loose, LOOSE_DIR_ATOL, LOOSE_RTOL)):
        np.testing.assert_allclose(psmp.direction.numpy()[lanes_],
                                   np.asarray(jsmp.direction)[lanes_],
                                   rtol=0, atol=dir_atol)
        for f in ("weight", "pdf", "directional_pdf", "lobe_roughness"):
            _close(getattr(psmp, f).numpy()[lanes_],
                   np.asarray(getattr(jsmp, f))[lanes_], rtol=rtol)
    assert N // 16 < loose.sum() < N // 4
    types = {int(t) for t in np.asarray(L["jm"].mat_type)[
        np.asarray(jsmp.pdf) > 0]}
    assert types == set(TYPES)     # every type sampled somewhere
    assert np.asarray(jsmp.is_delta).any() \
        and (np.asarray(jsmp.medium_event) != 0).any()


def test_evaluate_bsdf_matches_jax(lanes):
    L = lanes
    n, inc, wi = L["normal"], L["incident"], L["wi"]
    jev = jbsdf.evaluate_bsdf(L["jm"], jnp.zeros((N, 3)), jnp.asarray(n),
                              jnp.asarray(-inc), jnp.asarray(wi),
                              L["jclamp"], 0, jnp.ones(N), False, TYPES)
    pev = bsdf.evaluate_bsdf(L["pm"], torch.tensor(n), torch.tensor(-inc),
                             torch.tensor(wi), L["pclamp"], torch.ones(N),
                             TYPES)
    np.testing.assert_array_equal(pev.is_delta.numpy(),
                                  np.asarray(jev.is_delta))
    np.testing.assert_array_equal(pev.pdf.numpy() > 0,
                                  np.asarray(jev.pdf) > 0)
    _close(pev.value.numpy(), jev.value)
    _close(pev.pdf.numpy(), jev.pdf)
    assert (np.asarray(jev.pdf) > 0).sum() > N // 8


@pytest.fixture(scope="module")
def probe_scene():
    jm = dragon_class_scene_mesh(3, material=0)
    jr, pr = JResources(), SceneResources()
    jr.add_material(JMaterial())
    pr.add_material(Material())
    jr.add_mesh(jm)
    pr.add_mesh(Mesh(**{f.name: getattr(jm, f.name)
                        for f in dataclasses.fields(Mesh)}))
    return jr.build_arrays(), pr.build_arrays(device="cpu")


def _probes(js):
    """bench.py:136-146's probes (half aimed at the mesh bounds), with
    dead lanes and short windows mixed in."""
    rng = np.random.default_rng(7)
    o = rng.uniform(-3.0, 3.0, (N, 3)).astype(np.float32)
    v0 = np.asarray(js.triangles.v0)
    target = rng.uniform(v0.min(0), v0.max(0), (N // 2, 3)).astype(np.float32)
    d = rng.normal(size=(N, 3)).astype(np.float32)
    d[: N // 2] = target - o[: N // 2]
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    tmax = np.full(N, JC.INFINITY_T, np.float32)
    tmax[::61] = 0.0
    tmax[1::7] = rng.uniform(0.0, 4.0, len(tmax[1::7]))
    return o, d, tmax


def test_trace_any_reference_matches_trace_occluded(probe_scene):
    js, ps = probe_scene
    o, d, tmax = _probes(js)
    ref = jintersect.trace_occluded(jnp.asarray(o), jnp.asarray(d), js,
                                    JC.EPSILON_T, jnp.asarray(tmax))
    got = traverse.trace_any(torch.tensor(o), torch.tensor(d), C.EPSILON_T,
                             torch.tensor(tmax), ps.tri_bvh, ps.triangles)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert 0 < int(got.sum()) < N


def test_trace_any_walk_stops_at_first_hit(probe_scene):
    """The any-hit plain version's walk, which K1 any-hit's bound counts:
    the closest-hit walk cut at each lane's first hit inside the window,
    with the same flags."""
    js, ps = probe_scene
    o, d, tmax = (torch.tensor(x) for x in _probes(js))
    none = torch.full((N,), -1, dtype=torch.int32)
    w_any, w_all = {}, {}
    occ = traverse.trace_any_reference(o, d, C.EPSILON_T, tmax, ps.tri_bvh,
                                       ps.triangles, walk=w_any)
    closest = traverse.trace_closest_reference(
        o, d, C.EPSILON_T, tmax, ps.tri_bvh, ps.triangles, none, none,
        walk=w_all)
    assert torch.equal(occ, closest[1] >= 0)
    for k in ("nodes", "slots"):
        assert not (w_any[k] & ~w_all[k]).any(), k
    assert 0 < w_any["node_visits"] < w_all["node_visits"]
    assert 0 < w_any["tri_tests"] < w_all["tri_tests"]
    t, tri, _, _ = traverse.trace_closest_reference(
        o, d, C.EPSILON_T, tmax, ps.tri_bvh, ps.triangles, none, none,
        first_hit=True)
    assert torch.equal(tri >= 0, occ)
    assert ((t[occ] >= C.EPSILON_T) & (t[occ] < tmax[occ])).all()
    assert (t[occ] >= closest[0][occ]).all()

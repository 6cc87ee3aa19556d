"""The frozen generator against the port's own
(``scene/manager.py build_procedural_scene``): the same spheres and
materials; the configuration's settings equal to the port's
``RenderSettings`` defaults (upstream's ``RenderSettings.h``); the scene
handed to the port through its public API equal to the port's default
scene."""

from __future__ import annotations

import numpy as np
import pytest

from portbench import cells, jobs, scenegen
from metal_pathtracer_tpu_torch import constants as C
from metal_pathtracer_tpu_torch.scene.manager import build_procedural_scene
from metal_pathtracer_tpu_torch.scene.resources import SceneResources
from metal_pathtracer_tpu_torch.settings import RenderSettings

CONFIG = cells.load_json(cells.config_path("rtow"))


def _port_default():
    settings, res = RenderSettings(), SceneResources()
    build_procedural_scene(settings, res)
    return settings, res


def test_generator_equals_the_port_default_scene():
    spec = scenegen.build_spec(CONFIG)
    _, want = _port_default()
    assert np.array_equal(spec.spheres, np.asarray(
        [[*s.center, s.radius] for s in want.spheres], np.float64))
    assert spec.sphere_material.tolist() == [s.material
                                             for s in want.spheres]
    types = {"LAMBERTIAN": C.MATERIAL_LAMBERTIAN, "METAL": C.MATERIAL_METAL,
             "DIELECTRIC": C.MATERIAL_DIELECTRIC}
    assert len(spec.materials) == len(want.materials)
    for m, w in zip(spec.materials, want.materials):
        assert types[m["mat_type"]] == w.mat_type
        assert tuple(m["base_color"]) == tuple(w.base_color)
        assert (m["roughness"], m["ior"]) == (w.roughness, w.ior)
    assert spec.counts == {"spheres": 353, "materials": 335}


@pytest.mark.parametrize("key", sorted(CONFIG["settings"]))
def test_config_settings_are_the_upstream_defaults(key):
    settings, _ = _port_default()
    value = getattr(settings, key)
    if key == "backgroundMode":
        value = value.name
    elif isinstance(value, tuple):
        value = list(value)
    assert CONFIG["settings"][key] == value


def test_scene_through_the_port_api():
    spec = scenegen.build_spec(CONFIG)
    traffic = {"max_depth": 50, "width": 64, "height": 36}
    settings, res = scenegen.apply(spec, traffic, 2 ** 32 + 7,
                                   jobs.port_api())
    _, want = _port_default()
    assert res.spheres == want.spheres
    assert res.materials == want.materials
    assert settings.fixedRngSeed == 7
    assert (settings.renderWidth, settings.renderHeight) == (64, 36)

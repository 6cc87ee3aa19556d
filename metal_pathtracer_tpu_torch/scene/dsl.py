"""`.scene` DSL parser, grammar-compatible with the reference (the port's
own copy of the JAX package's ``scene/dsl.py``, record for record).

Line-oriented `keyword key=value ...` records with `\\` continuations and
`#` comments (reference: src/renderer/SceneManager.mm tokenize:907-930,
parseScene:795-905). Keywords: camera / renderer / background / material /
sphere / box / rectangle|rect. The `mesh` keyword needs the OBJ/PLY/glTF
loaders, which are not ported yet: it raises ``NotImplementedError``.
"""

from __future__ import annotations

import math
import os
from typing import Dict, Optional, Tuple

import numpy as np

from metal_pathtracer_tpu_torch import constants as C
from metal_pathtracer_tpu_torch.scene.resources import Material, SceneResources
from metal_pathtracer_tpu_torch.settings import (
    BackgroundMode,
    RenderSettings,
    SssMode,
)


class SceneParseError(ValueError):
    pass


_MATERIAL_TYPES = {
    "lambert": C.MATERIAL_LAMBERTIAN, "lambertian": C.MATERIAL_LAMBERTIAN,
    "metal": C.MATERIAL_METAL, "metallic": C.MATERIAL_METAL,
    "dielectric": C.MATERIAL_DIELECTRIC, "glass": C.MATERIAL_DIELECTRIC,
    "diffuse_light": C.MATERIAL_DIFFUSE_LIGHT, "light": C.MATERIAL_DIFFUSE_LIGHT,
    "emissive": C.MATERIAL_DIFFUSE_LIGHT,
    "plastic": C.MATERIAL_PLASTIC,
    "sss": C.MATERIAL_SUBSURFACE, "subsurface": C.MATERIAL_SUBSURFACE,
    "carpaint": C.MATERIAL_CARPAINT, "car_paint": C.MATERIAL_CARPAINT,
    "automotive": C.MATERIAL_CARPAINT,
}


def tokenize(line: str) -> Tuple[Optional[str], Dict[str, str]]:
    """First word is the keyword; remaining words must be key=value
    (reference: SceneManager.mm:907-930; words without '=' are skipped)."""
    words = line.split()
    if not words:
        return None, {}
    tokens = {}
    for word in words[1:]:
        if "=" not in word:
            continue
        key, _, value = word.partition("=")
        tokens[key] = value
    return words[0], tokens


def parse_float(value: str) -> float:
    try:
        return float(value.strip())
    except ValueError as exc:
        raise SceneParseError(f"expected a float, got {value!r}") from exc


def parse_uint(value: str) -> int:
    v = value.strip()
    if not v.isdigit():
        raise SceneParseError(f"expected a non-negative integer, got {value!r}")
    out = int(v)
    if out > 0xFFFFFFFF:
        raise SceneParseError(f"integer out of range: {value!r}")
    return out


def parse_float3(value: str):
    parts = value.split(",")
    comps = [0.0, 0.0, 0.0]
    for i, part in enumerate(parts[:3]):
        comps[i] = parse_float(part)
    if len(parts) < 3:
        raise SceneParseError(f"expected three comma-separated floats, got {value!r}")
    return tuple(comps)


def parse_bool_word(value: str) -> bool:
    lower = value.strip().lower()
    if lower in ("on", "true", "1"):
        return True
    if lower in ("off", "false", "0"):
        return False
    raise SceneParseError(f"expected on/off, got {value!r}")


def parse_float_range(value: str):
    """`a` or `a,b` -> (min, max, is_fixed)
    (reference: SceneManager.mm parseFloatRange:1020-1052)."""
    parts = value.split(",")
    if len(parts) == 1:
        v = parse_float(parts[0])
        return v, v, True
    lo = parse_float(parts[0])
    hi = parse_float(parts[1])
    if lo > hi:
        lo, hi = hi, lo
    return lo, hi, abs(hi - lo) < 1e-6


def _parse_camera(tokens, settings: RenderSettings):
    """(reference: SceneManager.mm parseCamera:1094-1162)"""
    if "target" in tokens:
        settings.cameraTarget = parse_float3(tokens["target"])
    if "distance" in tokens:
        settings.cameraDistance = max(parse_float(tokens["distance"]), 0.0)
    if "yaw" in tokens:
        settings.cameraYaw = parse_float(tokens["yaw"])
    if "pitch" in tokens:
        settings.cameraPitch = parse_float(tokens["pitch"])
    if "vfov" in tokens:
        settings.cameraVerticalFov = parse_float(tokens["vfov"])
    if "defocusAngle" in tokens:
        settings.cameraDefocusAngle = max(parse_float(tokens["defocusAngle"]), 0.0)
    if "focusDist" in tokens:
        settings.cameraFocusDistance = parse_float(tokens["focusDist"])


def _parse_renderer(tokens, settings: RenderSettings):
    """(reference: SceneManager.mm parseRenderer:1163-1542)"""
    if "samplesPerFrame" in tokens:
        settings.samplesPerFrame = max(1, parse_uint(tokens["samplesPerFrame"]))
    if "width" in tokens:
        settings.renderWidth = max(parse_uint(tokens["width"]), 8)
    if "height" in tokens:
        settings.renderHeight = max(parse_uint(tokens["height"]), 8)
    if "maxDepth" in tokens:
        settings.maxDepth = parse_uint(tokens["maxDepth"])
    if "tonemap" in tokens:
        settings.tonemapMode = max(1, min(parse_uint(tokens["tonemap"]), 4))
    if "exposure" in tokens:
        settings.exposure = parse_float(tokens["exposure"])
    if "envRotation" in tokens:
        settings.environmentRotation = parse_float(tokens["envRotation"])
    if "envIntensity" in tokens:
        settings.environmentIntensity = max(parse_float(tokens["envIntensity"]), 0.0)
    if "reinhardWhite" in tokens:
        settings.reinhardWhitePoint = parse_float(tokens["reinhardWhite"])
    if "seed" in tokens:
        settings.fixedRngSeed = parse_uint(tokens["seed"])
    if "russianRoulette" in tokens:
        settings.enableRussianRoulette = parse_uint(tokens["russianRoulette"]) != 0
    if "acesVariant" in tokens:
        settings.acesVariant = parse_uint(tokens["acesVariant"])
    for key in ("enableSoftwareRayTracing", "softwareRayTracing", "forceSoftwareBvh"):
        if key in tokens:
            settings.enableSoftwareRayTracing = parse_uint(tokens[key]) != 0
    if "sss" in tokens:
        lower = tokens["sss"].lower()
        if lower in ("off", "disabled", "0"):
            settings.sssMode = SssMode.OFF
        elif lower in ("separable", "diffusion", "approx"):
            settings.sssMode = SssMode.SEPARABLE
        elif lower in ("randomwalk", "random_walk", "random-walk"):
            settings.sssMode = SssMode.RANDOM_WALK
        else:
            raise SceneParseError("renderer sss expects off, separable, or randomwalk")
    if "sssMaxSteps" in tokens:
        settings.sssMaxSteps = max(1, parse_uint(tokens["sssMaxSteps"]))
    if "fireflyClampEnabled" in tokens:
        settings.fireflyClampEnabled = parse_uint(tokens["fireflyClampEnabled"]) != 0
    for key, attr in (
            ("fireflyClampFactor", "fireflyClampFactor"),
            ("fireflyClampFloor", "fireflyClampFloor"),
            ("throughputClamp", "throughputClamp"),
            ("specularTailClampBase", "specularTailClampBase"),
            ("specularTailClampRoughnessScale", "specularTailClampRoughnessScale"),
            ("minSpecularPdf", "minSpecularPdf"),
            ("fireflyClampMaxContribution", "fireflyClampMaxContribution")):
        if key in tokens:
            setattr(settings, attr, max(parse_float(tokens[key]), 0.0))
    for key, attr in (
            ("enableSpecularNee", "enableSpecularNee"),
            ("enableMnee", "enableMnee"),
            ("enableMneeSecondary", "enableMneeSecondary")):
        if key in tokens:
            setattr(settings, attr, parse_uint(tokens[key]) != 0)
    for key, attr in (
            ("gltfViewerCompatibilityMode", "gltfViewerCompatibilityMode"),
            ("gltfCompat", "gltfViewerCompatibilityMode"),
            ("gltfThinWalledFallback", "gltfThinWalledFallback"),
            ("gltfThinFallback", "gltfThinWalledFallback"),
            ("gltfCompatLinearBaseColor", "gltfCompatForceLinearBaseColor"),
            ("gltfCompatLinearEmissive", "gltfCompatForceLinearEmissive"),
            ("debugShowBaseColor", "debugShowBaseColor"),
            ("debugShowMetallic", "debugShowMetallic"),
            ("debugShowRoughness", "debugShowRoughness"),
            ("debugShowAO", "debugShowAO"),
            ("debugDisableAO", "debugDisableAO"),
            ("debugAoIndirectOnly", "debugAoIndirectOnly"),
            ("debugDisableNormalMap", "debugDisableNormalMap"),
            ("debugFlipNormalGreen", "debugFlipNormalGreen"),
            ("debugSpecularOnly", "debugSpecularOnly"),
            ("bloomEnabled", "bloomEnabled"),
            ("bloom", "bloomEnabled")):
        if key in tokens:
            setattr(settings, attr, parse_uint(tokens[key]) != 0)
    if "debugNormalStrengthScale" in tokens:
        settings.debugNormalStrengthScale = parse_float(tokens["debugNormalStrengthScale"])
    if "debugNormalLodBias" in tokens:
        settings.debugNormalLodBias = parse_float(tokens["debugNormalLodBias"])
    if "gltfEmissiveScale" in tokens:
        settings.gltfEmissiveScale = max(parse_float(tokens["gltfEmissiveScale"]), 0.0)
    if "bloomThreshold" in tokens:
        settings.bloomThreshold = max(parse_float(tokens["bloomThreshold"]), 0.0)
    if "bloomIntensity" in tokens:
        settings.bloomIntensity = max(parse_float(tokens["bloomIntensity"]), 0.0)
    if "bloomRadius" in tokens:
        settings.bloomRadius = max(parse_float(tokens["bloomRadius"]), 0.0)


def _parse_background(tokens, settings: RenderSettings, scene_directory: str):
    """(reference: SceneManager.mm parseBackground:1543-1597)"""
    has_solid = "solid" in tokens
    has_env = "env" in tokens
    if has_solid and has_env:
        raise SceneParseError("background cannot specify both solid and env")
    if has_solid:
        settings.backgroundMode = BackgroundMode.SOLID
        settings.backgroundColor = parse_float3(tokens["solid"])
        settings.environmentMapPath = ""
        return
    if has_env:
        value = tokens["env"]
        path = value
        if not os.path.isabs(path):
            base = scene_directory or "."
            if os.path.dirname(value):
                path = os.path.join(base, value)
            else:
                path = os.path.join(base, "HDR", value)
        path = os.path.normpath(path)
        if not os.path.exists(path):
            raise SceneParseError(f"background env map not found: {path}")
        settings.backgroundMode = BackgroundMode.ENVIRONMENT
        settings.backgroundColor = (0.0, 0.0, 0.0)
        settings.environmentMapPath = path
        return
    settings.backgroundMode = BackgroundMode.GRADIENT
    settings.backgroundColor = (0.0, 0.0, 0.0)
    settings.environmentMapPath = ""


def _parse_material(tokens, resources: SceneResources):
    """(reference: SceneManager.mm parseMaterial:1598-2132)"""
    if "type" not in tokens:
        raise SceneParseError("material requires a type token")
    type_word = tokens["type"].lower()
    if type_word not in _MATERIAL_TYPES:
        raise SceneParseError("material type is not recognized")
    mat_type = _MATERIAL_TYPES[type_word]

    base_color = (1.0, 1.0, 1.0)
    for key in ("base", "albedo", "color"):
        if key in tokens:
            base_color = parse_float3(tokens[key])
            break

    roughness = 0.0
    roughness_explicit = False
    if "roughness" in tokens:
        roughness = min(max(parse_float(tokens["roughness"]), 0.0), 1.0)
        roughness_explicit = True
    fuzz = 0.0
    if "fuzz" in tokens:
        fuzz = min(max(parse_float(tokens["fuzz"]), 0.0), 1.0)
    if not roughness_explicit:
        roughness = fuzz

    ior = 1.5
    ior_explicit = False
    if "ior" in tokens:
        ior = parse_float(tokens["ior"])
        ior_explicit = True
    coat_ior = 1.5
    if "coatIOR" in tokens:
        coat_ior = parse_float(tokens["coatIOR"])

    emission = (0.0, 0.0, 0.0)
    for key in ("emit", "emission"):
        if key in tokens:
            emission = parse_float3(tokens[key])
            break
    emission_env = False
    for key in ("emitEnv", "envPortal"):
        if key in tokens:
            emission_env = parse_uint(tokens[key]) != 0
            break

    if mat_type == C.MATERIAL_DIFFUSE_LIGHT:
        roughness = 0.0
        ior = 1.0

    name = tokens.get("name", "")
    thin = False
    for key in ("thin", "thinWalled", "thinDielectric"):
        if key in tokens:
            thin = parse_bool_word(tokens[key])
            break

    is_plastic = mat_type == C.MATERIAL_PLASTIC
    is_subsurface = mat_type == C.MATERIAL_SUBSURFACE
    is_carpaint = mat_type == C.MATERIAL_CARPAINT

    coat_roughness = 0.05 if (is_plastic or is_subsurface) else (0.04 if is_carpaint else 0.0)
    coat_thickness = 0.0
    coat_tint = (1.0, 1.0, 1.0)
    coat_absorption = (0.0, 0.0, 0.0)
    sss_coat = False

    # --- carpaint ----------------------------------------------------------
    cp_base_metallic = 0.0
    cp_base_roughness = roughness
    cp_base_eta = C.DEFAULT_CARPAINT_BASE_ETA
    cp_base_k = C.DEFAULT_CARPAINT_BASE_K
    cp_base_conductor_explicit = False
    cp_has_base_conductor = False
    cp_base_tint = (1.0, 1.0, 1.0)
    cp_flake_density = 0.0
    cp_flake_roughness = 0.15
    cp_flake_anisotropy = 0.0
    cp_flake_scale = 1.0
    cp_flake_normal_strength = 0.35
    cp_flake_reflectance = 1.0
    if is_carpaint:
        if "baseMetallic" in tokens:
            cp_base_metallic = min(max(parse_float(tokens["baseMetallic"]), 0.0), 1.0)
        if not roughness_explicit:
            cp_base_roughness = 0.2
        if "baseRoughness" in tokens:
            cp_base_roughness = min(max(parse_float(tokens["baseRoughness"]), 0.0), 1.0)
        elif roughness_explicit:
            cp_base_roughness = roughness
        cp_flake_density = max(parse_float(tokens["flakeDensity"]), 0.0) \
            if "flakeDensity" in tokens else 2000000.0
        cp_flake_roughness = min(max(parse_float(tokens["flakeRoughness"]), 0.0), 1.0) \
            if "flakeRoughness" in tokens else 0.15
        cp_flake_anisotropy = min(max(parse_float(tokens["flakeAnisotropy"]), -0.99), 0.99) \
            if "flakeAnisotropy" in tokens else 0.3
        cp_flake_scale = max(parse_float(tokens["flakeScale"]), 1e-4) \
            if "flakeScale" in tokens else 0.5
        if "flakeNormalStrength" in tokens:
            cp_flake_normal_strength = min(max(parse_float(tokens["flakeNormalStrength"]), 0.0), 1.0)
        if "flakeReflectanceScale" in tokens:
            cp_flake_reflectance = min(max(parse_float(tokens["flakeReflectanceScale"]), 0.0), 1.0)
        if "baseTint" in tokens:
            t = parse_float3(tokens["baseTint"])
            cp_base_tint = tuple(min(max(v, 0.0), 1.0) for v in t)
        if "baseEta" in tokens:
            cp_base_eta = tuple(max(v, 0.0) for v in parse_float3(tokens["baseEta"]))
            cp_base_conductor_explicit = True
        if "baseK" in tokens:
            cp_base_k = tuple(max(v, 0.0) for v in parse_float3(tokens["baseK"]))
            cp_base_conductor_explicit = True
        roughness = cp_base_roughness
        cp_has_base_conductor = cp_base_conductor_explicit or cp_base_metallic > 1e-4

    cp_flake_sample_weight = 0.0
    if is_carpaint:
        cp_flake_sample_weight = float(np.clip(cp_flake_density * 1e-7, 0.0, 0.6))
    else:
        cp_base_metallic = 0.0
        cp_base_roughness = 0.0
        cp_flake_density = 0.0
        cp_flake_roughness = 0.0
        cp_flake_anisotropy = 0.0
        cp_flake_normal_strength = 0.0
        cp_flake_scale = 1.0
        cp_flake_reflectance = 1.0
        cp_base_eta = (0.0, 0.0, 0.0)
        cp_base_k = (0.0, 0.0, 0.0)
        cp_has_base_conductor = False
        cp_base_tint = (1.0, 1.0, 1.0)

    if is_plastic or is_subsurface or is_carpaint:
        if "coatRoughness" in tokens:
            coat_roughness = min(max(parse_float(tokens["coatRoughness"]), 0.0), 1.0)
        if "coatThickness" in tokens:
            coat_thickness = max(parse_float(tokens["coatThickness"]), 0.0)
        if "coatTint" in tokens:
            coat_tint = tuple(min(max(v, 0.0), 1.0)
                              for v in parse_float3(tokens["coatTint"]))
        if "coatAbsorption" in tokens:
            coat_absorption = tuple(max(v, 0.0)
                                    for v in parse_float3(tokens["coatAbsorption"]))

    if is_plastic and not ior_explicit:
        ior = coat_ior
    if is_carpaint and not ior_explicit:
        ior = 1.5

    if is_subsurface and "coat" in tokens:
        sss_coat = parse_bool_word(tokens["coat"])

    conductor_eta = (0.0, 0.0, 0.0)
    conductor_k = (0.0, 0.0, 0.0)
    has_conductor = False
    if mat_type == C.MATERIAL_METAL:
        if "eta" in tokens:
            conductor_eta = parse_float3(tokens["eta"])
            has_conductor = True
        if "k" in tokens:
            conductor_k = parse_float3(tokens["k"])
            has_conductor = True

    sss_mfp = 0.0
    sss_g = 0.0
    sss_method = 0
    sss_sigma_a = (0.0, 0.0, 0.0)
    sss_sigma_s = (0.0, 0.0, 0.0)
    sss_sigma_override = False
    if is_subsurface:
        sss_mfp = 1.0
        if "method" in tokens:
            lower = tokens["method"].lower()
            if lower in ("separable", "diffusion"):
                sss_method = 0
            elif lower in ("randomwalk", "random_walk"):
                sss_method = 1
            else:
                raise SceneParseError("material method for sss must be separable or randomwalk")
        if "mfp" in tokens:
            sss_mfp = parse_float(tokens["mfp"])
        if "g" in tokens:
            sss_g = min(max(parse_float(tokens["g"]), -0.99), 0.99)
        sa_provided = "sigma_a" in tokens
        ss_provided = "sigma_s" in tokens
        if sa_provided != ss_provided:
            raise SceneParseError("material sigma_a and sigma_s must both be provided together")
        if sa_provided:
            sss_sigma_a = tuple(max(v, 0.0) for v in parse_float3(tokens["sigma_a"]))
            sss_sigma_s = tuple(max(v, 0.0) for v in parse_float3(tokens["sigma_s"]))
            sss_sigma_override = True
        sss_mfp = max(sss_mfp, 1e-4)

    dielectric_sigma_a = (0.0, 0.0, 0.0)
    if "sigmaA" in tokens:
        dielectric_sigma_a = tuple(max(v, 0.0) for v in parse_float3(tokens["sigmaA"]))
    elif "absorption" in tokens and "thickness" in tokens:
        absorption = parse_float3(tokens["absorption"])
        thickness = parse_float(tokens["thickness"])
        denom = max(thickness, 1e-6)
        dielectric_sigma_a = tuple(max(v / denom, 0.0) for v in absorption)

    return resources.add_material(Material(
        base_color=base_color,
        roughness=roughness,
        mat_type=mat_type,
        ior=ior,
        emission=emission,
        emission_env=emission_env,
        conductor_eta=conductor_eta,
        conductor_k=conductor_k,
        has_conductor=has_conductor,
        coat_roughness=coat_roughness,
        coat_thickness=coat_thickness,
        coat_tint=coat_tint,
        coat_absorption=coat_absorption,
        coat_ior=coat_ior,
        dielectric_sigma_a=dielectric_sigma_a,
        sss_sigma_a=sss_sigma_a,
        sss_sigma_s=sss_sigma_s,
        sss_mfp=sss_mfp,
        sss_g=sss_g,
        sss_method=sss_method,
        sss_coat=sss_coat,
        sss_sigma_override=sss_sigma_override,
        carpaint_base_metallic=cp_base_metallic,
        carpaint_base_roughness=cp_base_roughness,
        carpaint_flake_sample_weight=cp_flake_sample_weight,
        carpaint_flake_roughness=cp_flake_roughness,
        carpaint_flake_anisotropy=cp_flake_anisotropy,
        carpaint_flake_normal_strength=cp_flake_normal_strength,
        carpaint_flake_scale=cp_flake_scale,
        carpaint_flake_reflectance=cp_flake_reflectance,
        carpaint_base_eta=cp_base_eta,
        carpaint_base_k=cp_base_k,
        carpaint_has_base_conductor=cp_has_base_conductor,
        carpaint_base_tint=cp_base_tint,
        thin=thin,
        name=name,
    ))


def _parse_sphere(tokens, resources: SceneResources):
    """(reference: SceneManager.mm parseSphere:2133-2167)"""
    for req in ("center", "radius", "material"):
        if req not in tokens:
            raise SceneParseError("sphere requires center, radius, and material tokens")
    center = parse_float3(tokens["center"])
    radius = parse_float(tokens["radius"])
    material = parse_uint(tokens["material"])
    if material >= resources.material_count():
        raise SceneParseError(
            "sphere references material index that has not been defined yet")
    resources.add_sphere(center, radius, material)


def _parse_box(tokens, resources: SceneResources):
    """(reference: SceneManager.mm parseBox:2169-2263)"""
    for req in ("min", "max", "material"):
        if req not in tokens:
            raise SceneParseError("box requires min, max, and material tokens")
    mn = parse_float3(tokens["min"])
    mx = parse_float3(tokens["max"])
    material = parse_uint(tokens["material"])
    if material >= resources.material_count():
        raise SceneParseError(
            "box references material index that has not been defined yet")
    include_bottom = True
    if "includeBottom" in tokens:
        include_bottom = parse_uint(tokens["includeBottom"]) != 0
    two_sided = False
    if "twoSided" in tokens:
        two_sided = parse_uint(tokens["twoSided"]) != 0

    translate = (0.0, 0.0, 0.0)
    has_translate = "translate" in tokens
    if has_translate:
        translate = parse_float3(tokens["translate"])
    rotate_deg = 0.0
    has_rotate = "rotateY" in tokens
    if has_rotate:
        rotate_deg = parse_float(tokens["rotateY"])

    if not has_translate and not has_rotate:
        resources.add_box(mn, mx, material, None, include_bottom, two_sided)
        return

    rad = math.radians(rotate_deg)
    c, s = math.cos(rad), math.sin(rad)
    # Column-major rotation matching simd columns (SceneManager.mm:2252-2261):
    # columns[0]=(c,0,-s), columns[2]=(s,0,c) -> row-major rows below.
    rotation = np.array([
        [c, 0.0, s, 0.0],
        [0.0, 1.0, 0.0, 0.0],
        [-s, 0.0, c, 0.0],
        [0.0, 0.0, 0.0, 1.0]])
    translation = np.eye(4)
    translation[:3, 3] = translate
    transform = translation @ rotation
    resources.add_box(mn, mx, material, transform, include_bottom, two_sided)


def _parse_rectangle(tokens, resources: SceneResources):
    """(reference: SceneManager.mm parseRectangle:2265-2360)"""
    if "material" not in tokens:
        raise SceneParseError("rectangle requires a material token")
    material = parse_uint(tokens["material"])
    if material >= resources.material_count():
        raise SceneParseError(
            "rectangle references material index that has not been defined yet")

    axes = []
    for label in ("x", "y", "z"):
        if label not in tokens:
            raise SceneParseError(f"rectangle requires {label} token")
        axes.append(parse_float_range(tokens[label]))

    fixed = [i for i, a in enumerate(axes) if a[2]]
    if len(fixed) != 1:
        raise SceneParseError(
            "rectangle requires exactly one axis to be fixed to a single value")
    normal_axis = fixed[0]

    bounds_min = tuple(a[0] for a in axes)
    bounds_max = tuple(a[1] for a in axes)

    normal_positive = True
    if "normal" in tokens:
        normal_positive = parse_float(tokens["normal"]) >= 0.0
    two_sided = False
    if "twoSided" in tokens:
        two_sided = parse_uint(tokens["twoSided"]) != 0

    resources.add_rectangle(bounds_min, bounds_max, normal_axis,
                            normal_positive, two_sided, material)


def parse_scene(text: str, settings: RenderSettings,
                resources: SceneResources, scene_directory: str = "") -> None:
    """Parse scene text into settings + resources
    (reference: SceneManager.mm parseScene:795-905). A `mesh` record
    raises ``NotImplementedError`` (the mesh loaders: ROADMAP Queue 1,
    step 10)."""
    pending = ""
    pending_line = 0

    def flush(content: str, line_no: int):
        keyword, tokens = tokenize(content)
        if keyword is None:
            return
        try:
            if keyword == "camera":
                _parse_camera(tokens, settings)
            elif keyword == "renderer":
                _parse_renderer(tokens, settings)
            elif keyword == "background":
                _parse_background(tokens, settings, scene_directory)
            elif keyword == "material":
                _parse_material(tokens, resources)
            elif keyword == "sphere":
                _parse_sphere(tokens, resources)
            elif keyword == "box":
                _parse_box(tokens, resources)
            elif keyword in ("rectangle", "rect"):
                _parse_rectangle(tokens, resources)
            elif keyword == "mesh":
                raise NotImplementedError(
                    f"line {line_no}: mesh records need the OBJ/PLY/glTF "
                    "loaders (ROADMAP Queue 1, step 10)")
            # unknown keywords are silently ignored, like the reference
        except SceneParseError as exc:
            raise SceneParseError(f"line {line_no}: {exc}") from exc

    for line_no, raw in enumerate(text.splitlines(), start=1):
        line = raw.strip()
        if not line or line.startswith("#"):
            if pending:
                flush(pending, pending_line or line_no)
                pending = ""
                pending_line = 0
            continue
        continuation = line.endswith("\\")
        if continuation:
            line = line[:-1].strip()
        if line:
            if not pending:
                pending = line
                pending_line = line_no
            else:
                pending += " " + line
        if continuation:
            continue
        if pending:
            flush(pending, pending_line)
            pending = ""
            pending_line = 0

    if pending:
        flush(pending, pending_line)


def load_scene_file(path: str, settings: RenderSettings,
                    resources: SceneResources) -> None:
    with open(path, "r") as f:
        text = f.read()
    parse_scene(text, settings, resources,
                scene_directory=os.path.dirname(os.path.abspath(path)))

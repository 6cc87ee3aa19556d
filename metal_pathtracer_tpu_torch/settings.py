"""Render configuration (the port's own copy of the JAX package's
``settings.py``: the enums, ``RenderSettings`` with the same field
names and defaults, and the radiometric change detector that the
``Renderer`` facade and the live viewer reset accumulation with).

Field names keep the reference's camelCase spelling (reference:
include/renderer/RenderSettings.h:16-145), so a settings object of either
package drives either package.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Tuple


class BackgroundMode(enum.IntEnum):
    GRADIENT = 0
    SOLID = 1
    ENVIRONMENT = 2


class SssMode(enum.IntEnum):
    OFF = 0
    SEPARABLE = 1
    RANDOM_WALK = 2


class WorkingColorSpace(enum.IntEnum):
    LINEAR_SRGB = 0
    ACESCG = 1


@dataclasses.dataclass
class RenderSettings:
    """All render settings (reference: RenderSettings.h:16-145, same defaults)."""

    # Path tracing
    samplesPerFrame: int = 1
    maxDepth: int = 50
    enableRussianRoulette: bool = True
    fixedRngSeed: int = 0
    renderWidth: int = 0      # 0 => use default/view size
    renderHeight: int = 0     # 0 => use default/view size
    renderScale: float = 1.0  # internal render resolution multiplier (0.5x - 2.0x)
    enableSoftwareRayTracing: bool = False  # kept for CLI/DSL parity
    sssMode: SssMode = SssMode.OFF
    sssMaxSteps: int = 32
    enableSpecularNee: bool = True
    enableMnee: bool = False
    enableMneeSecondary: bool = True

    # Debug / parity harness (reference gates these behind PT_DEBUG_TOOLS)
    enablePathDebug: bool = False
    debugPixelX: int = 0
    debugPixelY: int = 0
    debugMaxEntries: int = 128

    # Tonemapping
    tonemapMode: int = 1        # 1=Linear, 2=ACES, 3=Reinhard, 4=Hable
    acesVariant: int = 0        # 0=Fitted, 1=Simple
    exposure: float = 0.0       # stops
    reinhardWhitePoint: float = 1.5
    bloomEnabled: bool = False
    bloomThreshold: float = 1.0
    bloomIntensity: float = 0.12
    bloomRadius: float = 1.5
    workingColorSpace: WorkingColorSpace = WorkingColorSpace.LINEAR_SRGB

    # glTF compatibility toggles
    gltfViewerCompatibilityMode: bool = False
    gltfThinWalledFallback: bool = True
    gltfEmissiveScale: float = 1.0
    gltfCompatForceLinearBaseColor: bool = False
    gltfCompatForceLinearEmissive: bool = False

    # PBR debug toggles
    debugShowBaseColor: bool = False
    debugShowMetallic: bool = False
    debugShowRoughness: bool = False
    debugShowAO: bool = False
    debugDisableAO: bool = False
    debugAoIndirectOnly: bool = True
    debugDisableNormalMap: bool = False
    debugDisableOrmTexture: bool = False
    debugFlipNormalGreen: bool = False
    debugSpecularOnly: bool = False
    debugNormalStrengthScale: float = 1.0
    debugNormalLodBias: float = 0.0
    debugOrmLodBias: float = 0.0
    debugEnvMipOverride: float = -1.0
    debugEnvNearest: bool = False

    # Camera (orbit model)
    cameraTarget: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    cameraDistance: float = 13.490737
    cameraYaw: float = 0.226799      # radians
    cameraPitch: float = 0.149000    # radians
    cameraVerticalFov: float = 20.0  # degrees
    cameraDefocusAngle: float = 0.0  # degrees; 0 disables depth of field
    cameraFocusDistance: float = 0.0  # 0 => auto (cameraDistance)

    # Background / environment
    backgroundMode: BackgroundMode = BackgroundMode.GRADIENT
    backgroundColor: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    environmentMapPath: str = ""
    environmentRotation: float = 0.0   # radians around world Y
    environmentIntensity: float = 1.0
    environmentMapDirty: bool = False

    # Firefly clamping / variance control
    fireflyClampEnabled: bool = True
    fireflyClampFactor: float = 32.0
    fireflyClampFloor: float = 4.0
    throughputClamp: float = 32.0
    specularTailClampBase: float = 0.0
    specularTailClampRoughnessScale: float = 0.0
    minSpecularPdf: float = 0.0
    fireflyClampMaxContribution: float = 1000.0

    # Denoising
    denoiseEnabled: bool = False
    denoiseFilterType: int = 0   # 0=RT, 1=RTLightmap
    denoiseUseAlbedo: bool = True
    denoiseUseNormal: bool = True
    denoiseFrequency: int = 4

    def copy(self) -> "RenderSettings":
        return dataclasses.replace(self)


# ---------------------------------------------------------------------------
# Radiometric change detection
# ---------------------------------------------------------------------------

# Fields whose change alters the rendered radiance and therefore must reset
# progressive accumulation (reference: src/renderer/SettingsUtils.mm:13-96).
# Maps field name -> human-readable reset reason.
_RADIOMETRIC_FIELDS = {
    "maxDepth": "MAX_DEPTH",
    "enableRussianRoulette": "RUSSIAN_ROULETTE",
    "fixedRngSeed": "RNG_SEED",
    "enableSoftwareRayTracing": "INTERSECTION_BACKEND",
    "sssMode": "SSS_MODE",
    "sssMaxSteps": "SSS_MAX_STEPS",
    "enableSpecularNee": "SPECULAR_NEE",
    "enableMnee": "MNEE",
    "enableMneeSecondary": "MNEE_SECONDARY",
    "workingColorSpace": "WORKING_COLOR_SPACE",
    "gltfViewerCompatibilityMode": "GLTF_COMPAT",
    "gltfThinWalledFallback": "GLTF_THIN_FALLBACK",
    "gltfEmissiveScale": "GLTF_EMISSIVE_SCALE",
    "gltfCompatForceLinearBaseColor": "GLTF_LINEAR_BASECOLOR",
    "gltfCompatForceLinearEmissive": "GLTF_LINEAR_EMISSIVE",
    "debugShowBaseColor": "DEBUG_VIEW",
    "debugShowMetallic": "DEBUG_VIEW",
    "debugShowRoughness": "DEBUG_VIEW",
    "debugShowAO": "DEBUG_VIEW",
    "debugDisableAO": "DEBUG_AO",
    "debugAoIndirectOnly": "DEBUG_AO",
    "debugDisableNormalMap": "DEBUG_NORMAL_MAP",
    "debugDisableOrmTexture": "DEBUG_ORM",
    "debugFlipNormalGreen": "DEBUG_NORMAL_MAP",
    "debugSpecularOnly": "DEBUG_SPECULAR_ONLY",
    "debugNormalStrengthScale": "DEBUG_NORMAL_MAP",
    "debugNormalLodBias": "DEBUG_LOD",
    "debugOrmLodBias": "DEBUG_LOD",
    "debugEnvMipOverride": "DEBUG_ENV_MIP",
    "debugEnvNearest": "DEBUG_ENV_FILTER",
    "cameraTarget": "CAMERA",
    "cameraDistance": "CAMERA",
    "cameraYaw": "CAMERA",
    "cameraPitch": "CAMERA",
    "cameraVerticalFov": "CAMERA",
    "cameraDefocusAngle": "CAMERA",
    "cameraFocusDistance": "CAMERA",
    "backgroundMode": "BACKGROUND",
    "backgroundColor": "BACKGROUND",
    "environmentMapPath": "ENVIRONMENT",
    "environmentRotation": "ENVIRONMENT",
    "environmentIntensity": "ENVIRONMENT",
    "fireflyClampEnabled": "FIREFLY_CLAMP",
    "fireflyClampFactor": "FIREFLY_CLAMP",
    "fireflyClampFloor": "FIREFLY_CLAMP",
    "throughputClamp": "THROUGHPUT_CLAMP",
    "specularTailClampBase": "SPECULAR_CLAMP",
    "specularTailClampRoughnessScale": "SPECULAR_CLAMP",
    "minSpecularPdf": "SPECULAR_CLAMP",
    "fireflyClampMaxContribution": "FIREFLY_CLAMP",
    "renderWidth": "RENDER_SIZE",
    "renderHeight": "RENDER_SIZE",
    "renderScale": "RENDER_SIZE",
}


def detect_radiometric_change(prev: RenderSettings, nxt: RenderSettings):
    """Field-by-field diff of two settings -> (changed, reason).

    Pure function mirroring the reference's radiometric change detector used
    to decide when progressive accumulation must restart
    (reference: src/renderer/SettingsUtils.mm:13-96).
    """
    for field, reason in _RADIOMETRIC_FIELDS.items():
        if getattr(prev, field) != getattr(nxt, field):
            return True, reason
    return False, ""

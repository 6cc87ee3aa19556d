"""Renderer facade, the public API of the framework
(``renderer/renderer.py`` twin).

The reference's pImpl facade (reference: include/MetalRenderer.h:13-52,
src/MetalRenderer.mm): init / drawFrame / resize / resetAccumulation /
setScene / loadSceneFromPath / applySettings / captureAverageImage /
exportToPPM, with the radiometric change detector driving accumulation
resets (reference: src/MetalRenderer.mm evaluateAccumulationState +
SettingsUtils.mm:13-96). It renders on ``device``: the card by default,
where it raises without one; the CPU (every kernel's plain version) only
when the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import logging
from typing import Optional, Tuple

import numpy as np
import torch

from metal_pathtracer_tpu_torch.ops.camera import build_camera
from metal_pathtracer_tpu_torch.renderer import frame as frame_mod
from metal_pathtracer_tpu_torch.renderer.accumulation import RenderState
from metal_pathtracer_tpu_torch.renderer.display import display_image
from metal_pathtracer_tpu_torch.scene.manager import (
    SceneManager,
    build_procedural_scene,
)
from metal_pathtracer_tpu_torch.scene.resources import SceneResources
from metal_pathtracer_tpu_torch.schema import (
    settings_to_static,
    settings_to_uniforms,
)
from metal_pathtracer_tpu_torch.settings import (
    BackgroundMode,
    RenderSettings,
    detect_radiometric_change,
)
from metal_pathtracer_tpu_torch.utils import image_io
from metal_pathtracer_tpu_torch.utils.spans import span

log = logging.getLogger("mpt.renderer")

# Render-size policy (reference: MetalRenderer.mm:1029-1122)
MAX_DIMENSION = 8192
MAX_PIXELS_WINDOWED = 16 * 1024 * 1024


class Renderer:
    """Progressive path tracing renderer with persistent accumulation."""

    def __init__(self, width: int = 1280, height: int = 720,
                 scenes_directory: str = "", device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Renderer: no CUDA device is available "
                               "(pass device='cpu' for the plain versions "
                               "on the CPU)")
        self.settings = RenderSettings()
        self._applied_settings = self.settings.copy()
        self.scene_manager = SceneManager(scenes_directory)
        self.resources = SceneResources()
        self._scene_arrays = None
        self._environment = None
        self._camera = None
        self._state: Optional[RenderState] = None
        self._scene_dirty = True
        self._logical = (width, height)  # window/drawable size pre-scale
        self._size = self._scaled_size(width, height)
        self.active_scene: str = ""

    # -- init / scene management (reference: MetalRenderer.mm:241-353) ----

    def init(self, initial_scene: str = "") -> None:
        if initial_scene and self.scene_manager.find_scene(initial_scene):
            self.load_scene(initial_scene)
        elif self.scene_manager.scene_names():
            self.load_scene(self.scene_manager.scene_names()[0])
        else:
            self.set_default_scene()

    def set_default_scene(self) -> None:
        self.resources = SceneResources()
        build_procedural_scene(self.settings, self.resources)
        self.active_scene = "<procedural>"
        self._scene_dirty = True
        self.reset_accumulation()

    def load_scene(self, name: str) -> None:
        resources = self.scene_manager.new_resources()
        settings = self.settings.copy()
        self.scene_manager.load_scene(name, settings, resources)
        self._adopt(name, settings, resources)

    def load_scene_from_path(self, path: str) -> None:
        resources = self.scene_manager.new_resources()
        settings = self.settings.copy()
        self.scene_manager.load_scene_from_path(path, settings, resources)
        self._adopt(path, settings, resources)

    def _adopt(self, name, settings, resources) -> None:
        self.settings = settings
        self._applied_settings = settings.copy()
        self.resources = resources
        self.active_scene = name
        # the cached environment stays: a scene loaded after another
        # renders under the previous map, as in the JAX package
        # (``renderer.py _adopt:87-96``); only ``apply_settings`` drops it
        self._scene_dirty = True
        if settings.renderWidth and settings.renderHeight:
            self._logical = (settings.renderWidth, settings.renderHeight)
            self._size = self._scaled_size(*self._logical, windowed=False)
        self.reset_accumulation()

    # -- settings (reference: MetalRenderer.mm applySettings + reset logic)

    def apply_settings(self, settings: RenderSettings) -> Optional[str]:
        """Apply new settings; returns the reset reason if accumulation
        restarted (the reference logs these, e.g. MATERIAL_EDIT)."""
        changed, reason = detect_radiometric_change(self._applied_settings,
                                                    settings)
        env_changed = (settings.environmentMapPath
                       != self._applied_settings.environmentMapPath)
        self.settings = settings
        self._applied_settings = settings.copy()
        # renderScale edits re-derive the render target from the logical
        # (window) size (MetalRenderer.mm:1029-1122); the RENDER_SIZE
        # reason comes from detect_radiometric_change above
        self._size = self._scaled_size(*self._logical)
        if env_changed:
            self._environment = None
            self._scene_dirty = True
        if changed:
            log.info("accumulation reset: %s", reason)
            self.reset_accumulation()
            return reason
        return None

    # -- sizing (reference: MetalRenderer.mm:1029-1122) --------------------

    def _scaled_size(self, width: int, height: int,
                     windowed: bool = True) -> Tuple[int, int]:
        scale = min(max(self.settings.renderScale, 0.5), 2.0)
        width = int(width * scale)
        height = int(height * scale)
        width = min(max(width, 8), MAX_DIMENSION)
        height = min(max(height, 8), MAX_DIMENSION)
        if windowed:  # the 16 MP cap applies to window targets only
            while width * height > MAX_PIXELS_WINDOWED:
                width = max(width // 2, 8)
                height = max(height // 2, 8)
        return (width, height)

    def resize(self, width: int, height: int) -> None:
        self._logical = (width, height)
        size = self._scaled_size(width, height)
        if size != self._size:
            self._size = size
            self.reset_accumulation()

    @property
    def render_size(self) -> Tuple[int, int]:
        if self.settings.renderWidth and self.settings.renderHeight:
            # explicit (headless) target: renderScale still applies, but
            # not the windowed 16 MP cap
            return self._scaled_size(self.settings.renderWidth,
                                     self.settings.renderHeight,
                                     windowed=False)
        return self._size

    # -- accumulation ------------------------------------------------------

    def reset_accumulation(self) -> None:
        self._state = None

    @property
    def state(self) -> RenderState:
        if self._state is None:
            w, h = self.render_size
            self._state = RenderState.create(w, h, self.device)
        return self._state

    def sample_count(self) -> int:
        if self._state is None:
            return 0
        return int(self._state.frame_index)

    # -- frame stepping (reference: MetalRenderer.mm drawFrame:700-1027) ---

    def _ensure_scene(self) -> None:
        if self._scene_dirty or self._scene_arrays is None:
            if self.settings.backgroundMode == BackgroundMode.ENVIRONMENT \
                    and self.settings.environmentMapPath \
                    and self._environment is None:
                from metal_pathtracer_tpu_torch.ops import env as env_ops
                self._environment = env_ops.load_environment(
                    self.settings.environmentMapPath, self.device)
            self._scene_arrays = self.resources.build_arrays(
                environment=self._environment, device=self.device)
            self._scene_dirty = False

    def draw_frame(self, samples: Optional[int] = None) -> RenderState:
        """Advance accumulation by ``samples`` (default samplesPerFrame)."""
        with span("mpt.frame_setup"):
            self._ensure_scene()
            w, h = self.render_size
            samples = samples or max(self.settings.samplesPerFrame, 1)
            static = settings_to_static(
                self.settings, w, h, self.resources.material_types_present(),
                self.resources.texture_slots_present(),
                self.resources.texture_uses_uv1())
            self._camera = build_camera(self.settings, w, h, self.device)
            uniforms = settings_to_uniforms(self.settings, self._camera, 0,
                                            0)
        self._state = frame_mod.render_samples(
            self._scene_arrays, uniforms, self.state, static, samples)
        return self._state

    # -- output (reference: MetalRenderer.mm captureAverageImage:2266-2328)

    def capture_average_image(self) -> np.ndarray:
        """Linear HDR (H,W,3) average, the reference's GPU->CPU blit."""
        return self.state.present().cpu().numpy()

    def display(self) -> np.ndarray:
        """Tonemapped LDR image following the display shader."""
        return display_image(self.state, self.settings).cpu().numpy()

    def export_to_ppm(self, path: str) -> None:
        """(reference: MetalRenderer.h exportToPPM)"""
        tm = image_io.TonemapSettings(
            tonemapMode=self.settings.tonemapMode,
            acesVariant=self.settings.acesVariant,
            exposure=self.settings.exposure,
            reinhardWhitePoint=self.settings.reinhardWhitePoint)
        image_io.write_ppm(path, self.capture_average_image(), tm)

    def save_exr(self, path: str) -> None:
        """(reference: MetalRenderer.mm EXR save :2330-2407)"""
        st = self.state
        image_io.write_exr_multilayer(
            path, self.capture_average_image(),
            albedo=st.albedo.cpu().numpy(),
            normal=(st.normal * 0.5 + 0.5).cpu().numpy(),
            samples=st.sample_count.cpu().numpy())

    # -- checkpoint / resume (SURVEY §5.4) ---------------------------------

    def save_checkpoint(self, path: str) -> None:
        self.state.save(path)

    def load_checkpoint(self, path: str) -> None:
        self._state = RenderState.load(path, device=self.device)
        self._size = (self._state.width, self._state.height)

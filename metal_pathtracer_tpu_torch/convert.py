"""Carry the JAX package's state across to the port.

The JAX package's ``SceneArrays`` (with its ``EnvironmentSoA`` and
``TextureArrays``),
``Uniforms``, ``StaticConfig`` and ``RenderState`` arrive as (nested)
dicts of numpy arrays and Python values,
one entry per field (the caller does the ``np.asarray``; this module never
imports jax). The functions below build the port's twins on a device, so
both packages can compute on identical scene, BVH, uniforms and
accumulation state. ``to_numpy`` turns a port object back into such a
dict.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from metal_pathtracer_tpu_torch.ops.kernels import primitives
from metal_pathtracer_tpu_torch.renderer.accumulation import RenderState
from metal_pathtracer_tpu_torch.schema import (
    BvhSoA,
    CameraUniforms,
    EnvironmentSoA,
    InstanceGroup,
    MaterialsSoA,
    RectsSoA,
    SceneArrays,
    SpheresSoA,
    StaticConfig,
    TextureArrays,
    TrianglesSoA,
    Uniforms,
)


def _build(cls, d: dict, device):
    """``cls`` from the entries of ``d`` named like its fields."""
    return cls(**{f.name: torch.tensor(np.asarray(d[f.name]), device=device)
                  for f in dataclasses.fields(cls)})


def environment(d: dict, device="cuda") -> EnvironmentSoA:
    """A JAX ``EnvironmentSoA`` (as a dict) on ``device``."""
    t = lambda a: torch.tensor(np.asarray(a), device=device)
    fields = {}
    for f in dataclasses.fields(EnvironmentSoA):
        v = d[f.name]
        if f.name == "mips":
            v = tuple(t(m) for m in v)
        elif f.name == "mip_meta":
            v = tuple(tuple(int(x) for x in m) for m in v)
        elif f.name in ("width", "height"):
            v = int(v)
        else:
            v = t(v)
        fields[f.name] = v
    return EnvironmentSoA(**fields)


def textures(d: dict, device="cuda") -> TextureArrays:
    """A JAX ``TextureArrays`` (as a dict) on ``device``."""
    return TextureArrays(**{
        f.name: int(d[f.name]) if f.name in ("n_textures", "max_levels")
        else torch.tensor(np.asarray(d[f.name]), device=device)
        for f in dataclasses.fields(TextureArrays)})


def instance_group(d: dict, device="cuda") -> InstanceGroup:
    """A JAX ``InstanceGroup`` (as a dict, its ``triangles`` and
    ``tri_bvh`` dicts too) on ``device``; its TPU packet BVH is not
    carried over."""
    t = lambda k: torch.tensor(np.asarray(d[k]), device=device)
    return InstanceGroup(
        triangles=_build(TrianglesSoA, d["triangles"], device),
        tri_bvh=_build(BvhSoA, d["tri_bvh"], device), l2w=t("l2w"),
        w2l=t("w2l"), nrm_mat=t("nrm_mat"), material=t("material"),
        base_id=int(d["base_id"]), count=int(d["count"]))


def scene_arrays(d: dict, device="cuda") -> SceneArrays:
    """Materials, spheres, rectangles and their light list, triangle soup,
    BVH, environment, texture atlas and instanced groups (``instanced``:
    a sequence of ``instance_group`` dicts), with the K3b layout of more
    than 32 spheres."""
    opt = lambda key, fn: None if d.get(key) is None else fn(d[key])
    spheres = opt("spheres", lambda x: _build(SpheresSoA, x, device))
    return SceneArrays(
        materials=_build(MaterialsSoA, d["materials"], device),
        triangles=opt("triangles",
                      lambda x: _build(TrianglesSoA, x, device)),
        tri_bvh=opt("tri_bvh", lambda x: _build(BvhSoA, x, device)),
        environment=opt("environment", lambda x: environment(x, device)),
        textures=opt("textures", lambda x: textures(x, device)),
        spheres=spheres,
        rects=opt("rects", lambda x: _build(RectsSoA, x, device)),
        light_rect_indices=opt(
            "light_rect_indices",
            lambda x: torch.tensor(np.asarray(x, np.int32).reshape(-1),
                                   device=device)),
        sphere_groups=None if spheres is None
        else primitives.groups_of(spheres),
        instanced=tuple(instance_group(g, device)
                        for g in d.get("instanced") or ()))


_UNIFORM_SCALARS = ("environment_", "firefly_", "throughput_", "specular_",
                    "min_specular", "debug_env", "debug_normal_strength")


def uniforms(d: dict, device="cuda") -> Uniforms:
    scalar = lambda k: np.asarray(d[k]).item()
    return Uniforms(
        camera=_build(CameraUniforms, d["camera"], device),
        frame_index=int(scalar("frame_index")),
        sample_count=int(scalar("sample_count")),
        fixed_rng_seed=int(scalar("fixed_rng_seed")),
        background_color=tuple(float(c) for c in
                               np.asarray(d["background_color"])),
        **{f.name: float(scalar(f.name))
           for f in dataclasses.fields(Uniforms)
           if f.name.startswith(_UNIFORM_SCALARS)
           and d.get(f.name) is not None})


def static_config(d: dict) -> StaticConfig:
    return StaticConfig(**{
        f.name: tuple(d[f.name])
        if f.name in ("material_types", "texture_slots") else d[f.name]
        for f in dataclasses.fields(StaticConfig)})


def render_state(d: dict, device="cuda") -> RenderState:
    t = lambda k: torch.tensor(np.asarray(d[k]), device=device)
    radiance = t("radiance_sum")
    sq = d.get("radiance_sq_sum")
    return RenderState(
        radiance_sum=radiance,
        sample_count=torch.tensor(
            np.asarray(d["sample_count"]).astype(np.int64), device=device),
        albedo=t("albedo"), normal=t("normal"),
        radiance_sq_sum=None if sq is None else t("radiance_sq_sum"),
        frame_index=int(np.asarray(d["frame_index"]).item()),
        ray_count=int(np.asarray(d.get("ray_count", 0)).item()),
        shadow_ray_count=int(np.asarray(d.get("shadow_ray_count", 0)).item()))


def to_numpy(obj):
    """A port dataclass as a nested dict of numpy arrays and plain values."""
    if dataclasses.is_dataclass(obj):
        return {f.name: to_numpy(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if torch.is_tensor(obj):
        return obj.cpu().numpy()
    if isinstance(obj, tuple):
        return tuple(to_numpy(x) for x in obj)
    return obj


def denoiser_params(d: dict, device="cuda") -> dict:
    """The denoisers' weights (a vendored ``.npz``'s arrays, the JAX
    package's parameter dicts or ``denoise_unet.init_params``) as float32
    tensors on ``device``: the tap MLP's ``w1`` (6, 16), ``b1``, ``w2``
    (16, 1), ``b2`` as they are, and each U-Net ``*_w`` from the JAX
    package's (3, 3, cin, cout) HWIO to ``conv2d``'s (cout, cin, 3, 3)
    OIHW, so both packages compute the same thing from the same file."""
    out = {}
    for k, v in d.items():
        x = torch.as_tensor(np.asarray(v), dtype=torch.float32)
        if k.endswith("_w") and x.dim() == 4:
            x = x.permute(3, 2, 0, 1)
        out[k] = x.contiguous().to(device)
    return out


def denoiser_arrays(params: dict) -> dict:
    """``denoiser_params``' way back: the port's denoiser weights (tensors
    on any device, e.g. ``DenoiseUNet.params()`` or the tap MLP's dict) as
    float32 numpy arrays in the JAX package's layout, each U-Net ``*_w``
    from OIHW to HWIO, the rest as they are; ``np.savez`` of the result
    is a file both packages' loaders read."""
    out = {}
    for k, v in params.items():
        x = v.detach().to("cpu", torch.float32)
        if k.endswith("_w") and x.dim() == 4:
            x = x.permute(2, 3, 1, 0)
        out[k] = x.contiguous().numpy().copy()
    return out

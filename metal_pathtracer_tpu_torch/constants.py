"""Scene capacity limits and numeric constants (the port's own copy of
``metal_pathtracer_tpu/constants.py``, value for value).

Mirrors the reference's shared constants (reference:
include/MetalShaderTypes.h:15-19, shaders/pathtrace.metal:19-36) so scenes
written against the reference behave identically here.
"""

MAX_SPHERES = 512
MAX_MATERIALS = 512
MAX_RECTANGLES = 128
MAX_MATERIAL_TEXTURES = 64
MAX_MATERIAL_SAMPLERS = 14

# Integrator epsilons (reference: shaders/pathtrace.metal:19-36).
INFINITY_T = 1.0e20
EPSILON_T = 1.0e-3
RAY_ORIGIN_EPSILON = 1.0e-4
SHADOW_EPSILON = 1.0e-3

# MIS weight clamps (reference: shaders/pathtrace.metal:40-41).
MIS_WEIGHT_CLAMP_MIN = 1.0e-4
MIS_WEIGHT_CLAMP_MAX = 0.9999

# Medium (nested dielectric) stack depth (reference: pathtrace.metal:5768-5773).
MAX_MEDIUM_STACK = 8

INVALID_INDEX = 0xFFFFFFFF

# Material type ids (reference: include/MetalShaderTypes.h:33-42).
MATERIAL_LAMBERTIAN = 0
MATERIAL_METAL = 1
MATERIAL_DIELECTRIC = 2
MATERIAL_DIFFUSE_LIGHT = 3
MATERIAL_PLASTIC = 4
MATERIAL_SUBSURFACE = 5
MATERIAL_CARPAINT = 6
MATERIAL_PBR = 7

# Primitive type tags used in hit records (reference: shaders/common.metal:352-355).
PRIMITIVE_NONE = 0
PRIMITIVE_SPHERE = 1
PRIMITIVE_RECTANGLE = 2
PRIMITIVE_TRIANGLE = 3

# Schlick average factor used for coat Fresnel averages
# (reference: src/renderer/SceneResources.mm ComputeCoatAverage).
SCHLICK_AVERAGE_FACTOR = 1.0 / 21.0

# Default carpaint base conductor (reference: SceneManager.mm:40-41).
DEFAULT_CARPAINT_BASE_ETA = (1.3456, 0.9652, 0.6172)
DEFAULT_CARPAINT_BASE_K = (7.4746, 6.3995, 5.3031)

# Rec.709 luminance weights (reference: shaders/pathtrace.metal kLuminanceWeights).
LUMINANCE_WEIGHTS = (0.2126, 0.7152, 0.0722)

"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` file compiles with its own ``nvcc`` process, all
started together, into an object file; one more ``nvcc`` links the
objects into a shared library with a plain C interface, loaded with
``ctypes`` (no PyTorch headers, so a build takes seconds). The library
lands in ``_build/`` inside the package, named by a hash of the sources
and flags, so an edited source rebuilds and an unchanged one is reused.

Flags: ``sm_90a`` (Hopper), ``-O3``, and ``--fmad=false`` so nvcc never
contracts ``a * b + c`` on its own: the kernels place their FMAs by hand
(``__fmaf_rn``) where the reference's XLA:CPU build contracts, which keeps
traces bit-identical to the plain versions. No ``--use_fast_math``:
division and ``sqrtf`` stay IEEE-rounded.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading

import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xptxas", "-v", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_lib = None

_vp = ctypes.c_void_p
_i = ctypes.c_int
_f = ctypes.c_float
_u = ctypes.c_uint32

#: C entry points: name -> argtypes (every pointer and the stream is a
#: c_void_p; each entry returns the cudaError_t of its launch)
SIGNATURES = {
    "mpt_trace_closest": [
        _i, _vp, _vp, _f, _vp, _vp, _vp,        # n, o, d, t_min, tmax, excl
        _i, _vp, _i, _vp,                       # packed nodes, slot records
        _vp, _vp, _vp, _vp,                     # out t tri u v
        _vp, _vp,                               # left siblings, totals
        _vp, _vp],                              # scratch, stream
    # n, the K2 instantiation (1: with plastic, carpaint and subsurface),
    # the sparse sweep (1) or a thread per lane (0), scalars (host
    # float[]), geometry pointers (host void*[]: hit t,
    # index, u, v, family, shade_packed, sphere and rectangle arrays),
    # material table, its row count, texture planes, random-walk planes
    # and states (NULL where absent), PathCarry pointers (host void*[]),
    # the probe plane (NULL without a probe), the bucket scratch (NULL: a
    # thread per lane), stream
    "mpt_shade_full": [_i, _i, _i, _vp, _vp, _vp, _i, _vp, _vp, _vp, _vp,
                       _vp, _vp, _vp],
    # K2 full's listing pass: n, scalars, geometry pointers, material types
    # (int32), their count, PathCarry pointers, the bucket scratch, stream
    "mpt_full_list": [_i, _vp, _vp, _vp, _i, _vp, _vp, _vp],
    # n, o, d, t_min, tmax, excl mesh/prim, placements, instance table,
    # concatenated packed nodes and slot records, TLAS nodes (count,
    # array), placement boxes, pad, out t tri u v inst, scratch, stream
    "mpt_trace_instanced_closest": [
        _i, _vp, _vp, _f, _vp, _vp, _vp, _i, _vp, _vp, _vp,
        _i, _vp, _vp, _f, _vp, _vp, _vp, _vp, _vp, _vp, _vp],
    # n, o, d, t_min, tmax, placements, table, nodes, records, TLAS nodes
    # (count, array), placement boxes, pad, out flags, scratch, stream
    "mpt_trace_instanced_any": [
        _i, _vp, _vp, _f, _vp, _i, _vp, _vp, _vp, _i, _vp, _vp, _f, _vp,
        _vp, _vp],
    "mpt_trace_any": [
        _i, _vp, _vp, _f, _vp,                  # n, o, d, t_min, tmax
        _i, _vp, _i, _vp,                       # packed nodes, slot records
        _vp, _vp, _vp,                          # out flags, left siblings,
        _vp, _vp],                              # totals, scratch, stream
    # n, the K2 instantiation, scalars, geometry pointers, material table,
    # its row count, the stage inputs (s1: environment background and pdf,
    # rect-light pdf, environment modulation, texture planes; s2:
    # transients, light samples, texture planes, random-walk planes and
    # states; NULL where absent), PathCarry pointers, output, the probe
    # plane (NULL without a probe), stream
    "mpt_shade_s1": [_i, _i, _vp, _vp, _vp, _i, _vp, _vp, _vp, _vp, _vp,
                     _vp, _vp, _vp, _vp],
    # s2 also takes its fork-state output (NULL: MNEE's secondary chain
    # off) after the output, and the live-lane list's scratch before the
    # stream
    "mpt_shade_s2": [_i, _i, _vp, _vp, _vp, _i, _vp, _vp, _vp, _vp, _vp,
                     _vp, _vp, _vp, _vp, _vp, _vp],
    # n, scalars (host float[]), t tri u v, texture material table, its row
    # count, carry / triangle attribute / atlas pointers (host void*[]),
    # texture count, levels per texture, instanced pointers (host void*[]:
    # families, instance table, the groups' shade_packed rows; NULL
    # without instances), soup triangle count, output planes, stream
    "mpt_texture_stage": [_i, _vp, _vp, _vp, _vp, _vp, _vp, _i,
                          _vp, _vp, _vp, _i, _i, _vp, _i, _vp, _vp],
    # n, o, d, t_min, t_max, the primitives (K3a, K3c: one packed record
    # each, SpheresSoA.records / RectsSoA.records; K3b: its group arrays),
    # their count, out t, out index, stream
    "mpt_sphere_nearest": [_i, _vp, _vp, _f, _vp, _vp, _i, _vp, _vp, _vp],
    # K3b also takes its live-lane list's scratch before the stream
    "mpt_sphere_nearest_chunked": [_i, _vp, _vp, _f, _vp,
                                   *[_vp] * 5, _i, _vp, _vp, _vp, _vp],
    "mpt_rect_nearest": [_i, _vp, _vp, _f, _vp, _vp, _i, _vp, _vp, _vp],
    # the à-trous pack: pixels, colour, luminance variance (NULL: 0),
    # albedo, normal, out carried float4s, out guide rows, stream
    "mpt_atrous_pack": [_i, _vp, _vp, _vp, _vp, _vp, _vp, _vp],
    # the à-trous iteration: mode, height, width, tap step, scalars (host
    # float[8]), the MLP's launch constants (host float[], NULL but in the
    # learned mode), carried float4s, guide rows, out float4s (NULL at
    # the last iteration), out colour, out variance (NULL in the fixed
    # mode), out weight sums (NULL but for a learned iteration under
    # training), stream
    "mpt_atrous_step": [_i, _i, _i, _i, _vp, _vp, _vp, _vp, _vp, _vp, _vp,
                        _vp, _vp],
    "mpt_atrous_mlp_floats": [],
    # the learned iteration's backward, first kernel: height, width, tap
    # step, scalars (host float[8]), the MLP's launch constants (host
    # float[]), carried float4s, guide rows, the forward's colour,
    # variance and weight sums, colour and variance cotangents (NULL: 0),
    # out tap weights, luminance adjoints, pixel terms (float4, float2),
    # the blocks' parameter rows, the block count, stream
    "mpt_atrous_grad_taps": [_i, _i, _i, _vp, _vp, _vp, _vp, _vp, _vp, _vp,
                             _vp, _vp, _vp, _vp, _vp, _vp, _vp, _i, _vp],
    # its block count at height, width and tap step; its blocks an SM
    "mpt_atrous_grad_blocks": [_i, _i, _i],
    "mpt_atrous_grad_blocks_per_sm": [],
    # second: height, width, tap step, the first's planes and pixel terms,
    # out colour and variance cotangents, stream
    "mpt_atrous_grad_gather": [_i, _i, _i, _vp, _vp, _vp, _vp, _vp, _vp,
                               _vp],
    # third: the rows' count, the rows, out (129), stream
    "mpt_atrous_grad_sum": [_i, _vp, _vp, _vp],
    # primary rays: n, x, y, previous counts (int64), the fixed seed,
    # frame index and sample count (uint32), width, height, the camera's
    # pointers (host void*[7]), out state, origin, direction, stream
    "mpt_primary_rays": [_i, _vp, _vp, _vp, _u, _u, _u, _f, _f, _vp, _vp,
                         _vp, _vp, _vp],
}


def floats(values) -> ctypes.Array:
    """A host float[] argument (kept alive by the caller's expression)."""
    return (ctypes.c_float * len(values))(*values)


def pointers(values) -> ctypes.Array:
    """A host void*[] argument of device pointers."""
    return (ctypes.c_void_p * len(values))(*values)


def planes(n: int, cols: int, device) -> torch.Tensor:
    """An (n, cols) float32 output stored plane-major: the transposed
    view of a contiguous (cols, n) tensor, so that column k is contiguous
    and a kernel stores plane k of lane i at ``k * n + i``."""
    return torch.empty((cols, n), dtype=torch.float32, device=device).t()


def list_scratch(n: int, device, keys: int = 1,
                 header: int = 2) -> torch.Tensor:
    """The int32 scratch of a kernel's live-lane lists: ``header`` counters
    (K1, K2 s2, K3b: the listed lanes and the fetch position), then
    ``keys`` lists of n lanes (K2 full: one per bucket)."""
    return torch.empty(header + keys * n, dtype=torch.int32, device=device)


def check_planes(who: str, x: torch.Tensor, n: int, cols: int) -> None:
    """Raise unless ``x`` is an (n, cols) float32 view of a contiguous
    (cols, n) tensor, the layout ``planes`` makes and the kernels read."""
    if x.shape != (n, cols) or x.dtype != torch.float32 \
            or not x.t().is_contiguous():
        raise ValueError(f"{who}: expected ({n}, {cols}) float32 planes "
                         f"stored plane-major (the .t() of a contiguous "
                         f"({cols}, {n}) tensor), got {tuple(x.shape)} "
                         f"{x.dtype} with strides {x.stride()}")


def check_aligned(who: str, tensors, align: int) -> None:
    """Raise unless every tensor starts on an ``align``-byte boundary (the
    kernels read them with ``align``-byte vector loads)."""
    for x in tensors:
        if x.data_ptr() % align:
            raise ValueError(f"{who}: a {tuple(x.shape)} tensor read with "
                             f"{align}-byte loads is not {align}-byte "
                             "aligned")


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    found = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin): the CUDA kernels cannot be "
                           "built")
    return found


def _sources():
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu"))
                  + glob.glob(os.path.join(CSRC_DIR, "*.cuh")))


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        with open(src, "rb") as fh:
            h.update(os.path.basename(src).encode() + fh.read())
    return os.path.join(BUILD_DIR, f"libmpt_kernels_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the kernels if this source hash has no library yet; returns
    the library path. The compiler's output (``-Xptxas -v``: registers,
    shared memory, spills per kernel) is kept beside it as ``.log``."""
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = nvcc_path()
    tag = f"{out[:-3]}.{os.getpid()}"
    jobs = []
    for src in (s for s in _sources() if s.endswith(".cu")):
        obj = f"{tag}.{os.path.basename(src)}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", obj, src]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    log, failed = [], []
    for cmd, _, proc in jobs:
        text, _ = proc.communicate(timeout=600)
        log.append(" ".join(cmd) + "\n" + text)
        if proc.returncode != 0:
            failed.append(text)
    if not failed:
        cmd = [nvcc, "-shared", "-o", f"{tag}.tmp",
               *[obj for _, obj, _ in jobs]]
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=600)
        log.append(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            failed.append(proc.stdout + proc.stderr)
    for _, obj, _ in jobs:
        if os.path.exists(obj):
            os.remove(obj)
    with open(out[:-3] + ".log", "w") as fh:
        fh.write("\n".join(log))
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    os.replace(f"{tag}.tmp", out)
    return out


def build_log() -> str:
    with open(library_path()[:-3] + ".log") as fh:
        return fh.read()


def load() -> ctypes.CDLL:
    """The kernel library, built on first use and loaded once per process."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def _kernel_name(mangled: str):
    """``name``, ``name<true|false>``, ``name<N>`` or, for several
    template arguments, ``name<false, true>`` of a mangled kernel symbol:
    the length-prefixed identifier ending in ``_kernel`` (the anonymous
    namespace's hash may run into the length's digits, so of the
    candidates the one that starts last), then its bool or int template
    arguments (``ILb0E``/``ILb1E``, ``ILi2E``, ``ILb0ELb1EE``) if any."""
    found = None
    for m in re.finditer(r"\d+", mangled):
        for k in range(len(m.group())):
            n = int(m.group()[k:])
            ident = mangled[m.end():m.end() + n]
            if ident.endswith("_kernel") and ident[0].isalpha():
                args = re.match(r"I((?:L[bi]\d+E)+)",
                                mangled[m.end() + n:])
                names = [] if args is None else [
                    v if t == "i" else "true" if v == "1" else "false"
                    for t, v in re.findall(r"L([bi])(\d+)E", args.group(1))]
                found = ident + (f"<{', '.join(names)}>" if names else "")
    return found


def register_counts(log: str) -> dict:
    """Registers per kernel instantiation in ``-Xptxas -v`` output, keyed
    ``name<flag>`` for a kernel templated on one bool (``name`` alone
    otherwise), e.g. ``shade_full_kernel<false>``."""
    counts, current = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            current = _kernel_name(m.group(1))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and current is not None:
            counts[current] = int(m.group(1))
            current = None
    return counts


def compile_registers(csrc_dir: str = CSRC_DIR) -> dict:
    """Compile every ``.cu`` of ``csrc_dir`` with the build's flags (objects
    thrown away) and return ``register_counts`` of the compiler's output:
    how two source trees' kernels compare."""
    log = []
    with tempfile.TemporaryDirectory() as tmp:
        for src in sorted(glob.glob(os.path.join(csrc_dir, "*.cu"))):
            proc = subprocess.run(
                [nvcc_path(), *NVCC_FLAGS, "-c", "-o",
                 os.path.join(tmp, "k.o"), src], capture_output=True,
                text=True, timeout=600)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
            log.append(proc.stdout + proc.stderr)
    return register_counts("\n".join(log))


def check(err: int, name: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


if __name__ == "__main__":
    # python -m metal_pathtracer_tpu_torch.ops.kernels.build [csrc_dir]:
    # the registers of each kernel instantiation in that source tree
    print(json.dumps(compile_registers(*sys.argv[1:2]), sort_keys=True))

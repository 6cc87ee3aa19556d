"""Build the repository's native helpers (``native/*.cpp``) on demand.

The ``.so`` files are not committed: ``native/build.sh`` compiles them on
first use, on the machine that runs them, into ``native/`` (git-ignored).
"""

from __future__ import annotations

import os
import subprocess
import threading

_NATIVE_DIR = os.path.normpath(os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "..", "..", "native"))
_lock = threading.Lock()
_attempted = False


def ensure_built(name: str) -> str | None:
    """Path to ``native/<name>``, built with ``native/build.sh`` if missing.

    The build is tried at most once per process; returns None when the
    library is absent and cannot be built (no compiler, build failure).
    """
    global _attempted
    path = os.path.join(_NATIVE_DIR, name)
    if os.path.exists(path):
        return path
    with _lock:
        if os.path.exists(path):
            return path
        if _attempted:
            return None
        _attempted = True
        script = os.path.join(_NATIVE_DIR, "build.sh")
        if not os.path.exists(script):
            return None
        try:
            subprocess.run(["bash", script], cwd=_NATIVE_DIR, check=True,
                           capture_output=True, timeout=300)
        except (OSError, subprocess.SubprocessError):
            return None
    return path if os.path.exists(path) else None


_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HOSTSRC_DIR = os.path.join(_PKG_DIR, "hostsrc")
HOST_BUILD_DIR = os.path.join(_PKG_DIR, "_build")
HOST_CFLAGS = ("-O2", "-shared", "-fPIC", "-std=c11")
_host_lock = threading.Lock()
_host_lib = None


def build_host_library() -> str:
    """Path to the port's host C library (``hostsrc/*.c``: the JPEG
    entropy decoders, Huffman, arithmetic and lossless, the JPEG block
    smoothing and the PNG filters), compiled with the host's ``cc``
    into ``_build/`` (git-ignored) at first use, named by a hash of the
    sources and flags. Raises ``RuntimeError`` when it cannot be built:
    nothing falls back to another decoder."""
    import glob
    import hashlib

    sources = sorted(glob.glob(os.path.join(HOSTSRC_DIR, "*.c")))
    h = hashlib.sha256(" ".join(HOST_CFLAGS).encode())
    for src in sources:
        with open(src, "rb") as fh:
            h.update(os.path.basename(src).encode() + fh.read())
    out = os.path.join(HOST_BUILD_DIR, f"libmpt_host_{h.hexdigest()[:16]}.so")
    with _host_lock:
        if os.path.exists(out):
            return out
        os.makedirs(HOST_BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        import shutil

        cc = os.environ.get("CC") or shutil.which("cc") or "gcc"
        try:
            proc = subprocess.run([cc, *HOST_CFLAGS, "-o", tmp, *sources],
                                  capture_output=True, text=True,
                                  timeout=300)
        except (OSError, subprocess.SubprocessError) as exc:
            raise RuntimeError(f"the host C library could not be built with "
                               f"{cc!r}: {exc}") from exc
        if proc.returncode != 0:
            raise RuntimeError(f"{cc} failed on {sources}:\n{proc.stderr}")
        os.replace(tmp, out)   # atomic: concurrent builds agree
    return out


def host_library():
    """The host C library, built on first use and loaded once, its entry
    points typed."""
    import ctypes

    global _host_lib
    path = build_host_library()
    with _host_lock:
        if _host_lib is None:
            lib = ctypes.CDLL(path)
            lib.mpt_jpeg_decode_scan.argtypes = [
                ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32,
                ctypes.c_void_p]
            lib.mpt_jpeg_decode_scan.restype = ctypes.c_int64
            lib.mpt_jpeg_decode_scan_arith.argtypes = [
                ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
            lib.mpt_jpeg_decode_scan_arith.restype = ctypes.c_int64
            lib.mpt_jpeg_decode_lossless.argtypes = \
                lib.mpt_jpeg_decode_scan.argtypes
            lib.mpt_jpeg_decode_lossless.restype = ctypes.c_int64
            lib.mpt_jpeg_smooth.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, *[ctypes.c_int] * 6,
                ctypes.c_void_p, ctypes.c_void_p]
            lib.mpt_jpeg_smooth.restype = None
            lib.mpt_png_unfilter.argtypes = [
                ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_int]
            lib.mpt_png_unfilter.restype = ctypes.c_int
            _host_lib = lib
    return _host_lib

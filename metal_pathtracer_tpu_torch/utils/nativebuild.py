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

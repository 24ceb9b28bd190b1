"""Build-at-first-use for the port's shared libraries.

Each library is compiled from sources in the checkout into `_build/` (git
ignored) under a name that carries a hash of its sources and command, so a
changed source rebuilds and an unchanged one is reused. The compiler writes
to a temporary name that is renamed into place, so concurrent processes
(test workers) never load a half-written file.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
import time

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO_DIR = os.path.dirname(PKG_DIR)
BUILD_DIR = os.path.join(PKG_DIR, "_build")

_lock = threading.Lock()
_locks: dict[str, threading.Lock] = {}
_loaded: dict[str, ctypes.CDLL] = {}


def build_and_load(name: str, cmd: list[str], sources: list[str],
                   headers: tuple[str, ...] = ()):
    """Compile `sources` with `cmd + [-o out] + sources` unless a build with
    the same hash (of the command, the sources and the `headers` they
    include) exists, then load it. Returns (CDLL, build_seconds), with 0.0
    seconds when nothing was compiled. Raises on a failed build."""
    h = hashlib.sha256(" ".join(cmd).encode())
    for src in list(sources) + list(headers):
        with open(src, "rb") as f:
            h.update(f.read())
    out = os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")
    with _lock:
        out_lock = _locks.setdefault(out, threading.Lock())
    # one lock per library: different libraries build concurrently
    with out_lock:
        if out in _loaded:
            return _loaded[out], 0.0
        seconds = 0.0
        if not os.path.exists(out):
            os.makedirs(BUILD_DIR, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            t0 = time.monotonic()
            proc = subprocess.run(
                cmd + ["-o", tmp] + sources, capture_output=True, text=True
            )
            seconds = time.monotonic() - t0
            if proc.returncode != 0:
                os.unlink(tmp)
                raise RuntimeError(
                    f"building {name} failed ({' '.join(cmd)}):\n"
                    f"{proc.stdout}\n{proc.stderr}"
                )
            os.replace(tmp, out)
        lib = ctypes.CDLL(out)
        _loaded[out] = lib
        return lib, seconds

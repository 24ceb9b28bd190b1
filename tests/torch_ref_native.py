"""Make the JAX package's native scene core loadable before a port test
builds a reference scene.

The reference loader (`ilgpu_raytracing_tpu/native/__init__.py`) runs
`make` when `native/libscenecore.so` is missing, and the Makefile writes
the library in place. A test worker that loads it while another worker is
still writing it fails `ctypes.CDLL`, remembers the failure for the rest of
the process, and the reference's BVH build then makes a median BVH where
an SAH one was asked for (`models/bvh.py:69-79`): the reference tables no
longer match the port's and a table test fails for a reason that has
nothing to do with the port.

`ensure_reference_native()` takes a file lock shared by every process of
this checkout, compiles the library with the Makefile's flags into a
temporary file that is renamed into place when it is missing, clears a
failed load of this process, and asserts that the reference can build SAH
tables.
"""

from __future__ import annotations

import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

import ilgpu_raytracing_tpu.native as ref_native

REPO_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE_DIR = os.path.join(REPO_DIR, "native")
LIB_PATH = os.path.join(NATIVE_DIR, "libscenecore.so")
# native/Makefile's CXXFLAGS
CXXFLAGS = ["-O3", "-march=native", "-fPIC", "-shared", "-std=c++17", "-Wall"]


def _lock_path() -> str:
    key = hashlib.sha1(REPO_DIR.encode()).hexdigest()[:16]
    return os.path.join(tempfile.gettempdir(), f"scenecore-{key}.lock")


def _compile() -> None:
    cxx = os.environ.get("CXX") or shutil.which("g++") or "g++"
    fd, tmp = tempfile.mkstemp(prefix=".libscenecore-", suffix=".so", dir=NATIVE_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [cxx, *CXXFLAGS, "-o", tmp, os.path.join(NATIVE_DIR, "scenecore.cpp")],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise AssertionError(
                f"the reference scene core does not build ({cxx}):\n{proc.stderr}")
        os.replace(tmp, LIB_PATH)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def ensure_reference_native(retries: int = 5) -> None:
    """Leave `ilgpu_raytracing_tpu.native` loaded in this process, or fail
    saying that the reference cannot build SAH tables."""
    with open(_lock_path(), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not os.path.exists(LIB_PATH):
                _compile()
            for attempt in range(retries):
                if ref_native._tried and ref_native._lib is None:
                    # an earlier load of this process failed: load again
                    ref_native._tried = False
                if ref_native.available():
                    return
                # a reference `make` of a process outside this lock may be
                # writing the file in place; give it time to finish
                time.sleep(0.5 * (attempt + 1))
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    raise AssertionError(
        "the JAX package's native scene core does not load "
        f"({LIB_PATH}): its BVH build would make median BVHs where SAH "
        "ones are asked for, and the reference tables would not be SAH tables")

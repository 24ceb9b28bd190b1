"""Hand-written Hopper kernels of the frame's hot path (counterpart of the
JAX package's ops/pallas/): the trace kernels K1/K2 (`wide`), K4/K5
(`stream`), K6 (`binary`), K7 (`treelet`), K8 (`streamtreelet`), the
counting sort K3 (`sortpos`) and the sort key it sorts by (`sortkey`),
ReSTIR DI (`restir`: candidates, reuse and selection of a bounce in one
launch), hit shading (`shade`: a hit record to its surface in one launch)
and the bounce's lane updates (`bounce`: one launch after ReSTIR, one after
the traces). `sortkey`, `restir`, `shade` and `bounce` port no Pallas
kernel: in the JAX package they are XLA-fused glue.

Sources live in `csrc/`; each is compiled by nvcc for sm_90a into a shared
library with a plain C interface (`utils/build.py`: at first use, into the
git-ignored `_build/`, rebuilt when the source changes) and bound with
ctypes. Pointers and PyTorch's current stream go in as `c_void_p`; every C
entry returns `cudaGetLastError()` and the wrapper raises on nonzero.

No `--use_fast_math`: the slab and Moller-Trumbore math keeps IEEE division
and sqrt. `--fmad=false` keeps multiply-adds unfused, so the kernels round
exactly as the plain PyTorch versions do and the two can be compared lane
for lane.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time

import torch

from ilgpu_raytracing_tpu_torch.utils.build import BUILD_DIR, PKG_DIR, build_and_load

CSRC = os.path.join(PKG_DIR, "csrc")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
]

VP = ctypes.c_void_p
CI = ctypes.c_int


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


# headers under csrc/ included by the sources; they are part of every
# library's build hash, so editing one rebuilds the libraries
HEADERS = ("trace_common.cuh", "node_walk.cuh", "wide_nodes.cuh",
           "stream_nodes.cuh", "stream_anyhit.cuh")


def load_kernel_library(name: str):
    """Build (at first use) and load csrc/<name>.cu. Returns (CDLL, seconds)."""
    return build_and_load(
        name, [_nvcc()] + NVCC_FLAGS, [os.path.join(CSRC, name + ".cu")],
        tuple(os.path.join(CSRC, h) for h in HEADERS),
    )


def ptxas_info(name: str) -> list[str]:
    """ptxas's report for csrc/<name>.cu under the build's flags (each
    kernel's registers, stack frame, spills, shared memory), from a cubin
    compiled into the build directory."""
    flags = [f for f in NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
    os.makedirs(BUILD_DIR, exist_ok=True)
    out = os.path.join(BUILD_DIR, f"{name}.cubin")
    proc = subprocess.run(
        [_nvcc()] + flags + ["-cubin", "-Xptxas", "-v", "-o", out,
                             os.path.join(CSRC, name + ".cu")],
        capture_output=True, text=True, check=True)
    return [ln.strip() for ln in (proc.stdout + proc.stderr).splitlines()
            if ("ptxas info" in ln or "stack frame" in ln) and "Compile time" not in ln]


def check(lib, prefix: str, err: int) -> None:
    """Raise with CUDA's message when a C entry returned an error."""
    if err != 0:
        fn = getattr(lib, prefix + "_error_string")
        fn.restype = ctypes.c_char_p
        fn.argtypes = [CI]
        raise RuntimeError(f"{prefix} kernel launch failed: {fn(err).decode()}")


def stream_ptr(t: torch.Tensor) -> int:
    """PyTorch's current stream on t's device, as the kernels take it."""
    return torch.cuda.current_stream(t.device).cuda_stream


def build_all() -> float:
    """Build every kernel library of the port, one nvcc per source, all
    started together; returns the wall seconds of the builds."""
    from concurrent.futures import ThreadPoolExecutor

    from ilgpu_raytracing_tpu_torch.ops.cuda import (
        binary,
        bounce,
        restir,
        shade,
        sortkey,
        sortpos,
        stream,
        streamtreelet,
        treelet,
        wide,
    )

    mods = (wide, stream, sortpos, binary, treelet, streamtreelet, restir, sortkey, shade,
            bounce)
    t0 = time.monotonic()
    with ThreadPoolExecutor(max_workers=len(mods)) as pool:
        for f in [pool.submit(m.library) for m in mods]:
            f.result()
    return time.monotonic() - t0

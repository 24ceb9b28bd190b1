"""PyTorch + CUDA port of the path tracer in `ilgpu_raytracing_tpu`.

The JAX package stays the reference; this package mirrors its layout
(`config`, `utils/`, `models/`, `ops/`, `runtime/`, `native/`) so the
counterpart of any module is found by its path. Plain tensor code is
PyTorch running eagerly; the Pallas kernels of the frame's hot path are
hand-written CUDA C++ for Hopper (`csrc/`, bound in `ops/cuda/`).

This package imports `torch` and never `jax` (nor anything of the JAX
package, whose `__init__` imports jax).
"""

from ilgpu_raytracing_tpu_torch.config import RenderConfig  # noqa: F401

"""K3: counting-sort position kernel (csrc/sortpos.cu) and its plain version.

`counting_pos(key, bins)` gives each lane its destination under a stable
counting sort of `key` (int32 in [0, bins)). On a CUDA tensor it launches
the kernel (or raises); on a CPU tensor it runs the plain one-hot
formulation of ops/sort.py:59-69, which is also the kernel's definition.
The CUDA path does not synchronize with the host: a key outside [0, bins)
fails the kernel's device-side assert, which the next synchronizing call
raises (as PyTorch's own index kernels do).
"""

from __future__ import annotations

import torch

from ilgpu_raytracing_tpu_torch.ops import cuda as cu
from ilgpu_raytracing_tpu_torch.utils import telemetry

MAX_BINS = 384  # rank pass keeps 16 warps x bins counters in shared memory

LAUNCHES = telemetry.counter("launches.sortpos", sortpos=0)

_state: dict[str, object] = {}


def library():
    """(CDLL, build seconds) of csrc/sortpos.cu, built at first use."""
    if "lib" not in _state:
        lib, seconds = cu.load_kernel_library("sortpos")
        lib.sortpos_counting_pos.restype = cu.CI
        lib.sortpos_counting_pos.argtypes = [cu.VP, cu.CI, cu.CI, cu.VP, cu.VP, cu.VP]
        lib.sortpos_tile.restype = cu.CI
        lib.sortpos_max_bins.restype = cu.CI
        if lib.sortpos_max_bins() < MAX_BINS:
            raise RuntimeError(f"sortpos kernel takes {lib.sortpos_max_bins()} bins, "
                               f"fewer than MAX_BINS={MAX_BINS}")
        _state["lib"] = lib
        return lib, seconds
    return _state["lib"], 0.0


def counting_pos_plain(key: torch.Tensor, bins: int) -> torch.Tensor:
    """One-hot formulation: exclusive per-bin running count + bin start,
    selected by key (int32 throughout, so 1.8M lanes x 129 bins is 0.9 GB)."""
    ar = torch.arange(bins, dtype=key.dtype, device=key.device)
    onehot = (key[:, None] == ar[None, :]).to(torch.int32)
    within = torch.cumsum(onehot, dim=0, dtype=torch.int32) - onehot
    counts = torch.sum(onehot, dim=0, dtype=torch.int32)
    starts = torch.cumsum(counts, dim=0, dtype=torch.int32) - counts
    return torch.sum(onehot * (within + starts[None, :]), dim=1, dtype=torch.int32)


def counting_pos(key: torch.Tensor, bins: int) -> torch.Tensor:
    """Stable counting-sort destination of every lane (int32 (N,))."""
    if key.dtype != torch.int32 or key.dim() != 1 or not key.is_contiguous():
        raise ValueError(
            f"counting_pos wants a contiguous 1-D int32 key, got "
            f"{key.dtype} {tuple(key.shape)}"
        )
    if not 1 <= bins <= MAX_BINS:
        raise ValueError(f"bins={bins} outside [1, {MAX_BINS}]")
    with telemetry.kernel("sortpos", key.shape[0]):
        if key.device.type == "cpu":
            if key.numel() and (int(key.min()) < 0 or int(key.max()) >= bins):
                raise ValueError(f"counting_pos: a key lies outside [0, {bins})")
            return counting_pos_plain(key, bins)
        return _launch(key, bins)


def _launch(key: torch.Tensor, bins: int) -> torch.Tensor:
    if key.device.type != "cuda":
        raise ValueError(f"counting_pos: unsupported device {key.device}")
    lib, _ = library()
    n = key.shape[0]
    if n >= 1 << 30:
        raise ValueError(f"counting_pos: {n} keys overflow the int32 positions")
    tiles = -(-n // lib.sortpos_tile())
    scratch = torch.empty((bins * tiles + bins,), dtype=torch.int32, device=key.device)
    pos = torch.empty((n,), dtype=torch.int32, device=key.device)
    err = lib.sortpos_counting_pos(key.data_ptr(), n, bins, scratch.data_ptr(),
                                   pos.data_ptr(), cu.stream_ptr(key))
    cu.check(lib, "sortpos", err)
    LAUNCHES["sortpos"] += 1
    return pos

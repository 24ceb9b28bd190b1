"""K3's plain version (ops/cuda/sortpos.counting_pos on CPU tensors) vs the
JAX package's Pallas counting kernel in interpret mode, exactly, on the
edge key sets that chip_smoke.py holds the CUDA kernel to, at a small n:
every key in one bin, descending keys, n = 1, 1,000 and 4,097 (one past
both the JAX block of 1,024 lanes and the CUDA tile of 4,096), and 1 and
384 bins. The CUDA kernel itself runs only on the card (chip_smoke.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ilgpu_raytracing_tpu.ops.pallas import sortpos_kernel as jspk
from ilgpu_raytracing_tpu_torch.ops.cuda import sortpos as tspk

torch.set_num_threads(1)

N = 5000


def _frame_keys(n, bins, rng):
    live = int(n * 0.7)
    return np.concatenate([rng.integers(0, bins - 1, size=live),
                           np.full(n - live, bins - 1)])


KEY_SETS = {
    "one_bin": lambda rng: (np.full(N, 57), 129),
    "descending": lambda rng: ((np.arange(N)[::-1] * 258) // N, 258),
    "n_1": lambda rng: (np.array([5]), 16),
    "n_1000": lambda rng: (rng.integers(0, 129, size=1000), 129),
    "n_4097": lambda rng: (_frame_keys(4097, 258, rng), 258),
    "bins_1": lambda rng: (np.zeros(N), 1),
    "bins_384": lambda rng: (rng.integers(0, 384, size=N), 384),
}


@pytest.mark.parametrize("name", list(KEY_SETS))
def test_plain_k3_equals_the_jax_kernel_on_edge_keys(name):
    keys, bins = KEY_SETS[name](np.random.default_rng(len(name)))
    keys = keys.astype(np.int32)
    ref = np.asarray(jspk.counting_pos(jnp.asarray(keys), bins, interpret=True))
    got = tspk.counting_pos(torch.as_tensor(keys), bins)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(ref, got.numpy())
    # a stable counting sort: pos is the inverse of the stable argsort
    np.testing.assert_array_equal(got.numpy()[np.argsort(keys, kind="stable")],
                                  np.arange(keys.size))
    assert tspk.LAUNCHES["sortpos"] == 0

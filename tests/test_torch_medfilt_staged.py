"""The median-filter kernel's schedule (TPU kernel #6, ``csrc/medfilt.cu``)
emulated in torch by ``medfilt_staged``: the tile route's shared core sort
and candidate select, and the radix route, against scipy.signal.medfilt and
the JAX Pallas kernel in interpret mode.

Tolerance: none. A median is one of its inputs, so every route must give
the same values as scipy bit for bit (``np.array_equal``; -0.0 and +0.0
compare equal there, as in scipy's own sort).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal as sps
import torch

from pydsproutines_tpu.ops.pallas.medfilt import medfilt_pallas
from pydsproutines_tpu_torch.ops.hopper.medfilt import (BLOCK_OUTPUTS,
                                                        MAX_SMEM, TILE_C,
                                                        medfilt_plan,
                                                        medfilt_staged)


def _signal(seed, n, dtype):
    """Noise with runs of ties, zeros and negative zeros."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n).astype(dtype)
    x[::7] = 0.0
    x[3::11] = -0.0
    x[n // 3: n // 3 + 40] = x[n // 3]
    return x


@pytest.mark.parametrize("n,k,dtype,c", [
    (1000, 129, np.float32, None),       # the detection chain's window
    (1000, 129, np.float32, 8),
    (777, 31, np.float32, None),         # a partial last tile
    (100, 129, np.float32, None),        # n < k
    (1000, 1, np.float32, None),         # k = 1: C = 1
    (1000, 3, np.float32, None),         # k < C: C cut to k//2 + 1 = 2
    (500, 7, np.float32, None),          # C = 4
    (513, 15, np.float64, None),         # C = 8 = k//2 + 1, float64 keys
    (3000, 129, np.float64, None),
    (2000, 1023, np.float32, None),
    (1001, 9, np.float32, 8),            # k = C + 1
    (1001, 15, np.float32, 16),          # k = C - 1: C cut to 8
    (700, 129, np.float32, 32), (700, 129, np.float32, 16),
    (700, 129, np.float32, 4), (700, 129, np.float64, 2),
    (700, 129, np.float32, 0),           # the radix route
    (700, 31, np.float64, 0),
])
def test_medfilt_staged_matches_scipy(n, k, dtype, c):
    x = _signal(n + k, n, dtype)
    got = medfilt_staged(torch.from_numpy(x), k, c).numpy()
    assert got.dtype == dtype and got.shape == (n,)
    np.testing.assert_array_equal(got, sps.medfilt(x, k))


@pytest.mark.parametrize("n,k", [(700, 31), (1000, 129), (300, 3), (90, 129)])
def test_medfilt_staged_matches_pallas_kernel(n, k):
    x = _signal(k, n, np.float32)
    pal = np.asarray(medfilt_pallas(jnp.asarray(x), k, interpret=True))
    np.testing.assert_array_equal(
        medfilt_staged(torch.from_numpy(x), k).numpy(), pal)


def test_medfilt_plan_routes_and_counts():
    plan = medfilt_plan(129)
    assert plan["route"] == "tile" and plan["c"] == TILE_C == 16
    assert plan["p"] == 128                       # 114 core keys, padded
    # 28 bitonic steps of 64 pairs a tile over 16 outputs, and the select
    assert plan["compares"] == 28 * 64 / 16 + 15 * 46
    assert plan["compares"] * 5 < 32 * 129        # the radix route's steps
    assert plan["smem"] == 4 * (2 * BLOCK_OUTPUTS + 128)
    eight = medfilt_plan(129, 4, 8)
    assert eight["c"] == 8 and eight["compares"] == 28 * 64 / 8 + 7 * 22
    assert medfilt_plan(3)["c"] == 2 and medfilt_plan(1)["c"] == 1
    assert medfilt_plan(3)["p"] == medfilt_plan(1)["p"] == 32   # a warp
    wide = medfilt_plan(1023, 8)                  # 1008 keys: E = 32 a lane
    assert wide["route"] == "tile" and wide["c"] == 16 and wide["p"] == 1024
    assert wide["smem"] <= MAX_SMEM
    assert medfilt_plan(1039)["route"] == "tile"  # 1024 keys at C = 16
    assert medfilt_plan(1041)["route"] == "radix-staged"    # 1026
    assert medfilt_plan(1041, 4, 32)["route"] == "radix-staged"  # not built
    for k in range(1, 1041, 2):           # the default width: always built
        plan = medfilt_plan(k)
        assert plan["route"] == "tile" and plan["p"] >= k - plan["c"] + 1
    assert medfilt_plan(2047)["route"] == "radix-staged"
    big = medfilt_plan(60_001)
    assert big["route"] == "radix-unstaged" and big["c"] == 0
    assert big["compares"] == 32 * 60_001
    assert medfilt_plan(129, 4, 0)["route"] == "radix-staged"

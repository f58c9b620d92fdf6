"""The sliding normalised matched filter (TPU kernel #7): the port's twin
against the JAX kernel in interpret mode and the numpy reference.

Tolerance: max|d| < 1e-5 on the 0..1 QF^2 scale, the JAX kernel test's
bound (``tests/test_extras.py:317``): f32 products and energies against
float64 numpy. The planted template's (t, shift) is exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pydsproutines_tpu.ops.pallas import sliding as js
from pydsproutines_tpu_torch.ops import sliding_multiply_normalised
from pydsproutines_tpu_torch.ops.hopper import sliding as ts


def _scene(seed, n, t, length, plant_t, plant_at):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(
        np.complex64)
    tm = (rng.standard_normal((t, length))
          + 1j * rng.standard_normal((t, length))).astype(np.complex64)
    x[plant_at: plant_at + length] += 4 * tm[plant_t]
    return x, tm


@pytest.mark.parametrize("n,t,length,plant_t,plant_at", [
    (2000, 3, 48, 1, 700),          # tests/test_extras.py:301's scene
    (1500, 1, 1, 0, 3),             # one-tap template
    (3000, 8, 200, 6, 1234),
])
def test_sliding_plain_matches_jax_kernel(n, t, length, plant_t, plant_at):
    x, tm = _scene(12, n, t, length, plant_t, plant_at)
    ref = np.asarray(js.sliding_multiply_normalised(
        jnp.asarray(x), tm, tile=128, interpret=True))
    truth = js.sliding_multiply_normalised_reference(x, tm)
    got = sliding_multiply_normalised(torch.from_numpy(x),
                                      torch.from_numpy(tm))
    assert got.dtype == torch.float32
    assert got.shape == ref.shape == (t, n - length + 1)
    assert np.abs(got.numpy() - ref).max() < 1e-5
    assert np.abs(got.numpy() - truth).max() < 1e-5
    np.testing.assert_array_equal(
        ts.sliding_multiply_normalised_reference(x, tm), truth)
    if length > 1:
        ti, si = np.unravel_index(int(torch.argmax(got)), got.shape)
        assert (ti, si) == (plant_t, plant_at)


def test_sliding_takes_numpy_and_one_template():
    x, tm = _scene(5, 600, 1, 32, 0, 100)
    got = sliding_multiply_normalised(x, tm[0])
    ref = js.sliding_multiply_normalised_reference(x, tm)
    assert got.shape == (1, 569)
    assert np.abs(got.numpy() - ref).max() < 1e-5


def test_sliding_zero_window_gives_zero():
    """A window of zeros has no energy: QF^2 is 0 there (the JAX kernel's
    rule), not the numpy reference's nan."""
    x, tm = _scene(6, 500, 2, 16, 0, 300)
    x[100:140] = 0
    got = ts.sliding_plain(torch.from_numpy(x), torch.from_numpy(tm))
    ref = np.asarray(js.sliding_multiply_normalised(
        jnp.asarray(x), tm, tile=128, interpret=True))
    assert np.all(got[:, 100:125].numpy() == 0)
    assert np.all(ref[:, 100:125] == 0)
    assert np.abs(got.numpy() - ref).max() < 1e-5


def test_sliding_checks_its_inputs():
    x = torch.zeros(3000, dtype=torch.complex64)
    with pytest.raises(ValueError, match="template length 2049"):
        sliding_multiply_normalised(x, torch.zeros((1, 2049),
                                                   dtype=torch.complex64))
    with pytest.raises(ValueError, match="longer than input"):
        sliding_multiply_normalised(x[:10], torch.zeros((1, 11),
                                                        dtype=x.dtype))
    with pytest.raises(ValueError, match="unsupported device"):
        sliding_multiply_normalised(x.to("meta"), torch.zeros(
            (1, 8), dtype=x.dtype))


def test_sliding_signature_matches_jax():
    import inspect
    ours = list(inspect.signature(sliding_multiply_normalised).parameters)
    theirs = list(inspect.signature(
        js.sliding_multiply_normalised).parameters)
    assert ours == theirs[:len(ours)] == ["x", "templates", "tile"]
    assert ts.MAX_TEMPLATE_LEN == js.MAX_TEMPLATE_LEN

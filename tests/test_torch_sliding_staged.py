"""The overlap-save schedule of the sliding matched-filter kernel (TPU
kernel #7, ``csrc/sliding.cu``) emulated in torch by ``sliding_staged``:
the segment FFTs over the kernel's f32 line tables, the inverse by
conjugation, the run-sum window energies and the precision re-check that
sends a segment to the direct f32 product.

Tolerance: max|d| < 1e-5 on the 0..1 QF^2 scale against the JAX kernel in
interpret mode and float64 numpy, the JAX kernel test's bound
(``tests/test_extras.py:317``); the planted (template, shift) exact; a
window of zeros exactly 0. The re-check's limit ``FLAG_RATIO`` is held to
its calibration: the FFT's error in QF^2 grows like sqrt(segment energy /
window energy), and at the limit it must stay a quarter of 2.5e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import burst_edge_scene
from pydsproutines_tpu.ops.pallas import sliding as js
from pydsproutines_tpu_torch.ops.hopper.sliding import (FLAG_RATIO,
                                                        sliding_plain,
                                                        sliding_plan,
                                                        sliding_staged)


def _scene(seed, n, t, length, plant_t, plant_at):
    """tests/test_torch_sliding.py's stationary scene."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(
        np.complex64)
    tm = (rng.standard_normal((t, length))
          + 1j * rng.standard_normal((t, length))).astype(np.complex64)
    x[plant_at: plant_at + length] += 4 * tm[plant_t]
    return x, tm


def _truth(x, tm):
    return js.sliding_multiply_normalised_reference(
        x.astype(np.complex128), tm.astype(np.complex128))


def _err(got, truth):
    """max|d| over the finite truth; where numpy divides 0 by 0 the
    contract's 0 must stand."""
    fin = np.isfinite(truth)
    assert np.all(got[~fin] == 0)
    return float(np.abs(got[fin] - truth[fin]).max())


@pytest.mark.parametrize("n,t,length,plant_t,plant_at", [
    (2000, 3, 48, 1, 700),          # tests/test_extras.py:301's scene
    (1500, 1, 1, 0, 3),             # one-tap template
    (3000, 8, 200, 6, 1234),
    (20_000, 4, 1024, 2, 7777),     # chip_smoke's geometry, cut to size
])
def test_sliding_staged_matches_jax_kernel(n, t, length, plant_t, plant_at):
    x, tm = _scene(12, n, t, length, plant_t, plant_at)
    got, flagged, _ = sliding_staged(torch.from_numpy(x), torch.from_numpy(tm))
    assert got.dtype == torch.float32 and got.shape == (t, n - length + 1)
    if length > 1:          # one tap: a near-zero sample is its window
        assert flagged == []                  # stationary: no re-check
    assert _err(got.numpy(), _truth(x, tm)) < 1e-5
    if n <= 3000:
        ref = np.asarray(js.sliding_multiply_normalised(
            jnp.asarray(x), tm, tile=128, interpret=True))
        assert np.abs(got.numpy() - ref).max() < 1e-5
    if length > 1:
        ti, si = np.unravel_index(int(torch.argmax(got)), got.shape)
        assert (ti, si) == (plant_t, plant_at)


def test_sliding_staged_burst_edge_scene():
    """-40 dB noise around a 20,000-sample burst holding the planted
    template, and a run of zeros: within 1e-5 of the JAX kernel and numpy,
    the segments at the burst's edges re-checked by the direct product."""
    x, tm = burst_edge_scene(7, 30_000, 2, 256, 1, 5000, 3000, 26_000, 1500)
    got, flagged, ratio = sliding_staged(torch.from_numpy(x),
                                         torch.from_numpy(tm))
    plan = sliding_plan(30_000, 2, 256)
    edges = {5000 // plan["valid"], 25_000 // plan["valid"]}
    assert flagged and set(flagged) <= {s for s in range(plan["segments"])
                                        if ratio[s] > FLAG_RATIO}
    assert edges & set(flagged)
    ref = np.asarray(js.sliding_multiply_normalised(
        jnp.asarray(x), tm, tile=512, interpret=True))
    assert np.abs(got.numpy() - ref).max() < 1e-5
    assert _err(got.numpy(), _truth(x, tm)) < 1e-5
    ti, si = np.unravel_index(int(torch.argmax(got)), got.shape)
    assert (ti, si) == (1, 8000)
    assert float(got[:, 26_000: 26_000 + 1500 - 256 + 1].abs().max()) == 0.0


def test_sliding_staged_recomputes_flagged_segments():
    """A flagged segment's shifts come from the direct f32 product: with
    every segment flagged the result is the twin's, and a segment's flag
    changes only that segment's shifts."""
    x, tm = burst_edge_scene(8, 12_000, 2, 200, 0, 3000, 1000, 10_500, 800,
                             burst_len=5000)
    xt, tt = torch.from_numpy(x), torch.from_numpy(tm)
    plan = sliding_plan(12_000, 2, 200)
    every, flagged, _ = sliding_staged(xt, tt, flag_ratio=0.0)
    assert flagged == list(range(plan["segments"]))
    assert float((every - sliding_plain(xt, tt)).abs().max()) < 1e-6
    none, no_flags, _ = sliding_staged(xt, tt, flag_ratio=float("inf"))
    some, flags, _ = sliding_staged(xt, tt)
    assert no_flags == [] and flags
    v = plan["valid"]
    for s in range(plan["segments"]):
        span = slice(s * v, (s + 1) * v)
        src = every if s in flags else none
        assert torch.equal(some[:, span], src[:, span])


def test_sliding_flag_ratio_is_calibrated():
    """Without the re-check the overlap-save error per segment stays under
    kappa * sqrt(ratio); at FLAG_RATIO that is a quarter of 2.5e-6 or less,
    and the deep scene's quietest segments lie beyond the limit."""
    kappa, deep = 0.0, 0.0
    for seed, length, db in ((1, 1024, -40.0), (2, 200, -40.0),
                             (3, 1024, -60.0)):
        x, tm = burst_edge_scene(seed, 40_000, 2, length, 1, 9000, 4000,
                                 33_000, 2500, noise_db=db)
        got, _, ratio = sliding_staged(torch.from_numpy(x),
                                       torch.from_numpy(tm),
                                       flag_ratio=float("inf"))
        truth = _truth(x, tm)
        v = sliding_plan(40_000, 2, length)["valid"]
        for s in range(ratio.shape[0]):
            span = slice(s * v, (s + 1) * v)
            r = float(ratio[s])
            if 100 < r < float("inf"):
                kappa = max(kappa, _err(got[:, span].numpy(),
                                        truth[:, span]) / np.sqrt(r))
            if db == -60.0:
                deep = max(deep, r)
    assert kappa > 0
    assert 4 * kappa * np.sqrt(FLAG_RATIO) < 2.5e-6
    assert deep > FLAG_RATIO

"""Parity of the PyTorch PSK demod stages with the JAX package.

Same complex64 numpy inputs to both. Symbol indices and the eye-opening
phase must be equal; the lock angle within 1e-5 rad (f32 sums of a few
hundred products in different orders) and the corrected samples within
1e-5 absolute.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pydsproutines_tpu.ops import demod as jd
from pydsproutines_tpu_torch.ops import demod as td


def _psk_burst(rng, m, nsyms, osr, phase, snr_amp=0.05):
    syms = rng.integers(0, m, nsyms)
    x = np.repeat(td.PSK_CONSTS[m][syms], osr) * np.exp(1j * phase)
    x = x + snr_amp * (rng.standard_normal(x.size)
                       + 1j * rng.standard_normal(x.size))
    return x.astype(np.complex64)


@pytest.mark.parametrize("osr", [2, 4, 8])
def test_get_eye_opening_matches_jax(rng, osr):
    x = _psk_burst(rng, 4, 128, osr, 0.3)
    x[1::osr] *= 1.5                         # a clear best phase
    jr, ji, jm = jd.get_eye_opening(jnp.asarray(x), osr)
    tr, ti, tm = td.get_eye_opening(torch.from_numpy(x), osr)
    assert int(ti) == int(ji) == 1
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-6)


@pytest.mark.parametrize("m,phase", [(2, 0.2), (4, 0.3), (4, -0.5), (8, 0.1)])
def test_lock_phase_and_map_syms_match_jax(rng, m, phase):
    x = _psk_burst(rng, m, 256, 1, phase)
    jc, jmet, jth = jd.lock_phase(jnp.asarray(x), m)
    tc, tmet, tth = td.lock_phase(torch.from_numpy(x), m)
    assert abs(float(tth) - float(jth)) < 1e-5
    assert abs(float(tmet) - float(jmet)) < 1e-5
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-5)
    js = np.asarray(jd.map_syms(jc, m))
    ts = td.map_syms(tc, m).numpy()
    assert ts.dtype == np.uint8
    np.testing.assert_array_equal(ts, js)


def test_sym_eig2_matches_jax():
    a, b, c = np.float32(3.0), np.float32(-1.25), np.float32(0.5)
    ref = jd._sym_eig2(jnp.asarray(a), jnp.asarray(b), jnp.asarray(c))
    got = td._sym_eig2(torch.tensor(a), torch.tensor(b), torch.tensor(c))
    for g, r in zip(got, ref):
        assert abs(float(g) - float(r)) < 1e-6

"""The Hopper kernels against their plain twins on the card (marker ``gpu``;
skipped where there is no CUDA device). Run on a GPU machine with

    python -m pytest tests/test_torch_hopper.py -q -m gpu --noconftest

(``--noconftest`` leaves out tests/conftest.py, which imports JAX; these
tests need only the port.)

Tolerances are chip_smoke.py's: WOLA max|d|/max|ref| < 1e-5; CAF per-shift
peak |X|^2 rtol 1e-4 with the planted shift and bin exact.
"""

import numpy as np
import pytest
import torch

from pydsproutines_tpu_torch.ops.hopper.fused_xcorr import (caf_peak,
                                                            caf_peak_plain)
from pydsproutines_tpu_torch.ops.hopper.wola_fused import wola_fused, wola_plain

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("n,taps,rows", [
    (64, 2048, 1000), (64, 512, 777), (128, 1024, 300), (256, 2048, 129),
    (16, 128, 50), (64, 64, 10),         # B = 1
])
def test_wola_kernel_matches_twin(cuda, n, taps, rows):
    rng = np.random.default_rng(n + taps + rows)
    h = torch.from_numpy(rng.standard_normal(taps).astype(np.float32)).to(cuda)
    x = torch.from_numpy((rng.standard_normal(rows * n + 3)
                          + 1j * rng.standard_normal(rows * n + 3))
                         .astype(np.complex64)).to(cuda)
    before = wola_fused.launches
    got = wola_fused(h, x, n)
    ref = wola_plain(h, x, n, n)
    torch.cuda.synchronize()
    assert wola_fused.launches == before + 1
    assert got.shape == (rows, n)
    assert float((got - ref).abs().max() / ref.abs().max()) < 1e-5


@pytest.mark.parametrize("n,step,nshifts,batch", [
    (1024, 1, 256, 128), (4096, 3, 40, 16), (1000, 1, 33, 8),
    (65536, 2, 12, 12),
])
def test_caf_kernel_matches_twin(cuda, n, step, nshifts, batch):
    rng = np.random.default_rng(n + step)
    cut = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    rxlen = (nshifts - 1) * step + n + 5
    rx = 0.5 * (rng.standard_normal(rxlen) + 1j * rng.standard_normal(rxlen))
    s_star, f_star = 3 * step, n // 3
    rx[s_star: s_star + n] += cut * np.exp(2j * np.pi * f_star
                                           * np.arange(n) / n)
    cc = torch.from_numpy(np.conj(cut).astype(np.complex64)).to(cuda)
    rxt = torch.from_numpy(rx.astype(np.complex64)).to(cuda)
    km, kb = caf_peak(rxt, cc, 0, step, nshifts, batch)
    pm, pb = caf_peak_plain(rxt, cc, 0, step, nshifts, batch)
    torch.cuda.synchronize()
    assert float(((km - pm).abs() / pm).max()) < 1e-4
    assert int(torch.argmax(km)) == int(torch.argmax(pm)) == 3
    assert int(kb[3]) == int(pb[3]) == f_star

"""The upfirdn kernel's schedule (TPU kernels #5/#5b, ``csrc/upfirdn.cu``)
emulated in torch by ``upfirdn_staged``: the block tiling by phase period,
each lane's register window walked over the residue classes of the taps,
the input span's and the outputs' edge masks, against scipy.signal.upfirdn
in float64, the JAX ``upfirdn`` and the JAX Pallas kernel in interpret mode.

The same numpy inputs, made from a seed, go to both sides. Tolerances:
scipy's float64 result against float32 planes within tests/test_filters.py's
atol 2e-4*sqrt(T), rtol 1e-4 (f32 sums of up to a few hundred taps);
float64 planes within 1e-9; the plain twin within 1e-5 of max|ref| (the
twins' bound).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal as sps
import torch

import pydsproutines_tpu.ops.filters as JF
from pydsproutines_tpu.ops.pallas.upfirdn import _upfirdn_pallas_planes2
from pydsproutines_tpu_torch.ops.hopper.upfirdn import (
    SMEM_BUDGET, get_upfirdn_size, tap_table, upfirdn_plan,
    upfirdn_planes_plain, upfirdn_staged)

RATIOS = [(1, 1), (1, 4), (5, 4), (4, 5), (3, 1), (7, 3)]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _truth(h, x, up, down, n_out):
    full = sps.upfirdn(h.astype(np.float64), x.astype(np.complex128), up,
                       down)
    out = np.zeros(n_out, np.complex128)
    out[: min(n_out, full.size)] = full[:n_out]
    return out


@pytest.mark.parametrize("up,down", RATIOS)
@pytest.mark.parametrize("taps", [2, 37, 146])
def test_upfirdn_staged_matches_scipy_float32(up, down, taps):
    """Both edges (n short against the taps at 146), taps < up (2 at 3/1,
    5/4, 4/5, 7/3); the planes of one complex64 tensor, under the plan of
    two planes as float2."""
    rng = np.random.default_rng(up * 1000 + down * 100 + taps)
    n = 700
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(
        np.complex64)
    h = rng.standard_normal(taps).astype(np.float32)
    xt = _t(x)
    got = upfirdn_staged((xt.real, xt.imag), _t(h), up, down, comps=2)
    n_out = get_upfirdn_size(n, taps, up, down)
    assert got[0].shape == (n_out,)
    np.testing.assert_allclose(got[0].numpy() + 1j * got[1].numpy(),
                               _truth(h, x, up, down, n_out),
                               atol=2e-4 * np.sqrt(taps), rtol=1e-4)
    ref = upfirdn_planes_plain((xt.real, xt.imag), _t(h), up, down)
    scale = float(torch.stack(ref).abs().max())
    assert float((torch.stack(got) - torch.stack(ref)).abs().max()) \
        < 1e-5 * scale


@pytest.mark.parametrize("up,down", RATIOS + [(8, 7), (2, 3)])
@pytest.mark.parametrize("n", [1, 17, 256])
def test_upfirdn_staged_matches_scipy_float64(up, down, n):
    rng = np.random.default_rng(up * 10 + down + n)
    for taps in (1, 4, 15, 101):
        x = rng.standard_normal(n)
        h = rng.standard_normal(taps)
        (got,) = upfirdn_staged((_t(x),), _t(h), up, down)
        ref = sps.upfirdn(h, x, up, down)
        assert got.shape == ref.shape
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-9)


@pytest.mark.parametrize("up,down,n_out", [(5, 4, 100), (5, 4, 2000),
                                           (7, 3, 1), (1, 4, 513)])
def test_upfirdn_staged_n_out_override(up, down, n_out):
    """Outputs cut short, and asked for past the full length (zeros there):
    nothing past n_out is written."""
    rng = np.random.default_rng(n_out)
    x = rng.standard_normal((2, 300)).astype(np.float32)
    h = rng.standard_normal(60).astype(np.float32)
    got = upfirdn_staged((_t(x[0]), _t(x[1])), _t(h), up, down, n_out)
    assert all(g.shape == (n_out,) for g in got)
    np.testing.assert_allclose(got[0].numpy() + 1j * got[1].numpy(),
                               _truth(h, x[0] + 1j * x[1], up, down, n_out),
                               atol=2e-4 * np.sqrt(60), rtol=1e-4)


def test_upfirdn_staged_rows_and_strided_planes():
    """2-D planes (rows) read at element stride 2 from a wider buffer."""
    rng = np.random.default_rng(3)
    wide = rng.standard_normal((3, 2 * 500)).astype(np.float32)
    h = rng.standard_normal(33).astype(np.float32)
    plane = _t(wide)[:, ::2]
    (got,) = upfirdn_staged((plane,), _t(h), 4, 5)
    for r in range(3):
        np.testing.assert_allclose(
            got[r].numpy(), sps.upfirdn(h.astype(np.float64),
                                        wide[r, ::2].astype(np.float64), 4,
                                        5), atol=2e-4 * np.sqrt(33),
            rtol=1e-4)


@pytest.mark.parametrize("up,down", [(5, 4), (3, 7), (1, 1)])
def test_upfirdn_staged_matches_jax(up, down):
    rng = np.random.default_rng(up + down)
    x = rng.standard_normal(1000).astype(np.float32)
    h = rng.standard_normal(95).astype(np.float32)
    (got,) = upfirdn_staged((_t(x),), _t(h), up, down)
    ref = np.asarray(JF.upfirdn(jnp.asarray(h), jnp.asarray(x), up, down))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-4 * np.sqrt(95),
                               rtol=1e-4)


def test_upfirdn_staged_matches_pallas_kernel_interpret():
    """The TPU kernel itself in interpret mode, at the smallest geometry its
    gate takes (tests/test_torch_filters.py's pad-free case)."""
    from pydsproutines_tpu.ops.pallas.upfirdn import upfirdn_geometry
    up, down, T = 1, 4, 257
    n = upfirdn_geometry(up, down)[3] * 264
    n_out = JF.get_upfirdn_size(n, T, up, down)
    rng = np.random.default_rng(257)
    x = rng.standard_normal((2, n)).astype(np.float32)
    h = rng.standard_normal(T).astype(np.float32)
    pal = np.asarray(_upfirdn_pallas_planes2(
        jnp.asarray(x[0]), jnp.asarray(x[1]), jnp.asarray(h), up, down, n_out,
        interpret=True))
    got = np.stack([g.numpy() for g in upfirdn_staged(
        (_t(x[0]), _t(x[1])), _t(h), up, down, n_out)])
    np.testing.assert_allclose(got, pal, atol=2e-4 * np.sqrt(T), rtol=1e-4)


def test_upfirdn_tap_table():
    """Entry [c, rho, t] is h[p_c + (rho + t*S)*up], zero past lh or T."""
    h = torch.arange(1, 24, dtype=torch.float64)          # T = 23
    tab = tap_table(h, 5, 4, 8)                            # P 5, S 4, lh 5
    assert tab.shape == (5, 4, 8)
    for c in range(5):
        pc = (c * 4) % 5
        for rho in range(4):
            for t in range(8):
                k, l = pc + (rho + 4 * t) * 5, rho + 4 * t
                want = float(h[k]) if l < 5 and k < 23 else 0.0
                assert float(tab[c, rho, t]) == want


def test_upfirdn_plan_chain_and_variants():
    chain = upfirdn_plan(730, 5, 4)
    assert (chain["P"], chain["S"], chain["lh"], chain["m"], chain["tpad"],
            chain["nir"], chain["threads"]) == (5, 4, 146, 16, 37, 1, 160)
    assert chain["route"] == "window-staged" and chain["smem"] <= SMEM_BUDGET
    # lanes 64 samples apart: one pad a 64 samples puts them on 32 banks
    assert chain["xsh"] == 6 and chain["osh"] == 5
    pair = upfirdn_plan(730, 5, 4, 4, 2)
    assert pair["route"] == "window-staged-float2"
    assert pair["smem"] > chain["smem"]
    short = upfirdn_plan(9, 3, 1)
    assert short["m"] == 4 and short["tpad"] == 3 and short["nir"] == 2
    assert upfirdn_plan(30_000, 1, 1)["route"] == "window-unstaged"
    assert upfirdn_plan(9, 1, 20_000)["route"] == "window-unstaged"
    big_p = upfirdn_plan(95, 160, 147)
    assert big_p["threads"] == 512 and big_p["nir"] == 1

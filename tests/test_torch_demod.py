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


# ---------------------------------------------------------------------------
# The rest of the demodulation layer. Symbols, bits, indices and rotations
# must be equal to the JAX package's; lock angles, reimc and svd_metric
# within 1e-5. Scenes are planted (a clear best phase, preamble and
# rotation), so no decision rests on a last-bit difference.
# ---------------------------------------------------------------------------

from pydsproutines_tpu.ops import viterbi as jv  # noqa: E402
from pydsproutines_tpu.signal import make_cpfsk_syms  # noqa: E402
from pydsproutines_tpu_torch import ops as tops  # noqa: E402

LOCK_ATOL = 1e-5


def _constellation_points(rng, n, scale=1.0):
    return (scale * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
            ).astype(np.complex64)


def test_every_public_name_of_the_jax_layer_is_exported():
    """Each public name of the JAX ops/demod.py and ops/viterbi.py has a
    counterpart in pydsproutines_tpu_torch.ops (and its __all__)."""
    for mod in (jd, jv):
        names = {n for n, v in vars(mod).items() if not n.startswith("_")
                 and (getattr(v, "__module__", None) == mod.__name__
                      or isinstance(v, dict))}
        assert names, mod.__name__
        missing = sorted(n for n in names if n not in tops.__all__
                         or not hasattr(tops, n))
        assert not missing, (mod.__name__, missing)


def test_psk_tables_are_the_jax_tables():
    for m in (2, 4, 8):
        np.testing.assert_array_equal(td.PSK_BITMAPS[m], jd.PSK_BITMAPS[m])
        np.testing.assert_array_equal(td.PSK_CONSTS[m], jd.PSK_CONSTS[m])


def test_specialized_maps_match_jax(rng):
    x = _constellation_points(rng, 4096)
    t = torch.from_numpy(x)
    np.testing.assert_array_equal(td.map_syms_bpsk(t).numpy(),
                                  np.asarray(jd.map_syms_bpsk(x)))
    np.testing.assert_array_equal(td.map_syms_qpsk(t).numpy(),
                                  np.asarray(jd.map_syms_qpsk(x)))
    for eo in (0.7, 1.3):
        got = td.map_syms_8psk(t, eo)
        assert got.dtype == torch.uint8
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jd.map_syms_8psk(x, np.float32(eo))))


@pytest.mark.parametrize("m", [2, 4, 8])
def test_compare_int_preambles_matches_jax(rng, m):
    syms = rng.integers(0, m, 300).astype(np.uint8)
    amble = rng.integers(0, m, 24).astype(np.uint8)
    got = td.compare_int_preambles(torch.from_numpy(amble),
                                   torch.from_numpy(syms), m, 5, 200, 24)
    ref = jd.compare_int_preambles(jnp.asarray(amble), jnp.asarray(syms), m,
                                   5, 200, 24)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    with pytest.raises(ValueError, match="run past"):
        td.compare_int_preambles(torch.from_numpy(amble),
                                 torch.from_numpy(syms), m, 100, 200, 24)


@pytest.mark.parametrize("m,bitmap,shift", [
    (2, None, 0), (4, None, 0), (4, None, 3), (8, None, 5),
    (4, np.array([0, 1, 3, 2], np.uint8), 1)])
def test_syms_to_bits_matches_jax(rng, m, bitmap, shift):
    syms = rng.integers(0, m, 500).astype(np.uint8)
    got = td.syms_to_bits(torch.from_numpy(syms), m, bitmap, shift)
    ref = jd.syms_to_bits(jnp.asarray(syms), m,
                          None if bitmap is None else jnp.asarray(bitmap),
                          shift)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_pack_unpack_and_find_plain_text_match_jax(rng):
    text = b"the quick brown fox jumps over the lazy dog, twice over"
    pairs = np.unpackbits(np.frombuffer(text, np.uint8)).reshape(-1, 2)
    inv = np.argsort(td.PSK_BITMAPS[4]).astype(np.uint8)
    syms = np.concatenate([rng.integers(0, 4, 3).astype(np.uint8),
                           inv[pairs[:, 0] * 2 + pairs[:, 1]]])
    vals = rng.integers(0, 8, 64).astype(np.uint8)
    unpacked = td.unpack_to_binary_bytes(vals, 8)
    np.testing.assert_array_equal(unpacked, jd.unpack_to_binary_bytes(vals, 8))
    np.testing.assert_array_equal(td.pack_binary_bytes_to_bits(unpacked),
                                  jd.pack_binary_bytes_to_bits(unpacked))
    i_t, c_t = td.find_plain_text(torch.from_numpy(syms), 4)
    i_j, c_j = jd.find_plain_text(syms, 4)
    assert i_t == i_j == 3
    np.testing.assert_array_equal(c_t, c_j)


def test_detect_b_or_q_matches_jax(rng):
    b = _psk_burst(rng, 2, 1000, 1, 0.4)
    q = _psk_burst(rng, 4, 1000, 1, -0.2)
    rows = np.stack([b, q])
    m_t, r_t = td.detect_b_or_q(torch.from_numpy(rows))
    m_j, r_j = jd.detect_b_or_q(jnp.asarray(rows))
    np.testing.assert_array_equal(m_t.numpy(), np.asarray(m_j))
    np.testing.assert_array_equal(m_t.numpy(), [2, 4])
    np.testing.assert_allclose(r_t.numpy(), np.asarray(r_j), atol=LOCK_ATOL)
    m1, _ = td.detect_b_or_q(torch.from_numpy(q))
    assert m1.shape == (1,) and int(m1[0]) == 4


@pytest.mark.parametrize("cls,m", [("SimpleDemodulatorPSK", 2),
                                   ("SimpleDemodulatorPSK", 4),
                                   ("SimpleDemodulatorPSK", 8),
                                   ("SimpleDemodulatorBPSK", 2),
                                   ("SimpleDemodulatorQPSK", 4),
                                   ("SimpleDemodulator8PSK", 8)])
def test_simple_demodulators_match_jax(rng, cls, m):
    """demod -> amble_rotate -> syms_to_bits on a planted burst: a clear
    best phase, a residual rotation, a preamble at symbol 37."""
    osr, nsyms, amble_at = 4, 300, 37
    x = _psk_burst(rng, m, nsyms, osr, 0.25)
    x[2::osr] *= 1.6
    generic = cls == "SimpleDemodulatorPSK"
    jdem = getattr(jd, cls)(m) if generic else getattr(jd, cls)()
    tdem = getattr(td, cls).from_numpy_params(
        {"m": m, "bitmap": jdem.bitmap,
         "cluster_threshold": jdem.cluster_threshold}, device="cpu")
    js = np.asarray(jdem.demod(jnp.asarray(x), osr))
    ts = tdem.demod(torch.from_numpy(x), osr)
    np.testing.assert_array_equal(ts.numpy(), js)
    assert int(tdem.xeo_i) == int(jdem.xeo_i) == 2
    np.testing.assert_array_equal(tdem.xeo.numpy(), np.asarray(jdem.xeo))
    np.testing.assert_allclose(tdem.eo_metric.numpy(),
                               np.asarray(jdem.eo_metric), rtol=1e-6)
    assert abs(float(tdem.angleCorrection)
               - float(jdem.angleCorrection)) < LOCK_ATOL
    assert abs(float(tdem.svd_metric) - float(jdem.svd_metric)) < LOCK_ATOL
    np.testing.assert_allclose(tdem.reimc.numpy(), np.asarray(jdem.reimc),
                               atol=LOCK_ATOL)
    amble = js[amble_at: amble_at + 24]
    jr = jdem.amble_rotate(jnp.asarray(amble), search=np.arange(10, 60))
    tr = tdem.amble_rotate(amble, search=np.arange(10, 60))
    assert int(tr[1]) == int(jr[1]) == amble_at
    assert int(tr[2]) == int(jr[2]) == 0 and int(tr[3]) == int(jr[3]) == 24
    np.testing.assert_array_equal(tr[0].numpy(), np.asarray(jr[0]))
    np.testing.assert_array_equal(tdem.matches.numpy(),
                                  np.asarray(jdem.matches))
    # a rotated preamble: rotation and shift found alike
    rot_amble = (amble.astype(int) + 1) % m
    jr = jdem.amble_rotate(jnp.asarray(rot_amble))
    tr = tdem.amble_rotate(rot_amble)
    assert [int(v) for v in tr[1:]] == [int(v) for v in jr[1:]] \
        == [amble_at, 1, 24]
    np.testing.assert_array_equal(tr[0].numpy(), np.asarray(jr[0]))
    for shift in (0, 1):
        np.testing.assert_array_equal(
            tdem.syms_to_bits(phase_sym_shift=shift).numpy(),
            np.asarray(jdem.syms_to_bits(phase_sym_shift=shift)))


# -- the burst-batched chain --------------------------------------------------

def _batch_scene(rng, m, B, nsyms, osr, amble, shifts, snr_amp=0.05):
    """B bursts: random symbols, ``amble`` planted at each row's shift, a
    per-burst phase, a clear best sampling phase, noise."""
    rows = []
    for b in range(B):
        syms = rng.integers(0, m, nsyms)
        syms[shifts[b]: shifts[b] + amble.size] = amble
        x = np.repeat(td.PSK_CONSTS[m][syms], osr) * np.exp(
            1j * rng.uniform(-np.pi, np.pi))
        x[(b % osr)::osr] *= 1.6
        x = x + snr_amp * (rng.standard_normal(x.size)
                           + 1j * rng.standard_normal(x.size))
        rows.append(x)
    return np.stack(rows).astype(np.complex64)


def _assert_batch_equal(got, ref, rows=None):
    rows = slice(None) if rows is None else rows
    for name in ("syms", "eo_idx", "best_matches", "best_rotations",
                 "best_idx", "rotated_syms", "bits", "bit_counts"):
        np.testing.assert_array_equal(getattr(got, name).numpy()[rows],
                                      np.asarray(getattr(ref, name))[rows],
                                      err_msg=name)
    for name in ("theta", "svd_metric", "reimc"):
        np.testing.assert_allclose(getattr(got, name).numpy()[rows],
                                   np.asarray(getattr(ref, name))[rows],
                                   atol=LOCK_ATOL, err_msg=name)
    np.testing.assert_allclose(got.eo_metric.numpy()[rows],
                               np.asarray(ref.eo_metric)[rows], rtol=1e-6)


@pytest.mark.parametrize("variant,m", [("generic", 4), ("bpsk", 2),
                                       ("qpsk", 4), ("8psk", 8)])
def test_batch_demod_variants_match_jax(rng, variant, m):
    osr, nsyms, B = 4, 160, 6
    shifts = rng.integers(0, 20, B)
    amble = rng.integers(0, m, 16)
    x = _batch_scene(rng, m, B, nsyms, osr, amble, shifts)
    jdem = jd.DemodulatorBatchPSK(m, variant)
    tdem = td.DemodulatorBatchPSK.from_numpy_params(
        {"m": m, "variant": variant, "bitmap": jdem.bitmap}, device="cpu")
    # the preamble in the integers this variant maps to: the symbols the
    # chain decides where it was planted
    first = tdem.demod_batch(torch.from_numpy(x), osr, amble, 0, 20, 100)
    amble_m = first.syms[0, shifts[0]: shifts[0] + 16].numpy()
    ref = jdem.demod_batch(jnp.asarray(x), osr, jnp.asarray(amble_m),
                           search_start=0, search_len=20, num_out_syms=100)
    got = tdem.demod_batch(torch.from_numpy(x), osr, amble_m,
                           search_start=0, search_len=20, num_out_syms=100)
    _assert_batch_equal(got, ref)
    assert int(got.best_idx[0]) == shifts[0]
    assert int(got.best_matches[0]) == 16


def test_batch_demod_qpsk_ragged_matches_jax_row_by_row(rng):
    """Ragged lengths (garbage past each burst's end), checked row by row
    against the JAX chain and, at the port's own single-burst chain, on the
    truncated burst."""
    m, osr, nsyms, B, alen, n_out = 4, 4, 128, 5, 16, 48
    amble = rng.integers(0, m, alen)
    shifts = np.array([0, 3, 7, 2, 5])
    x = _batch_scene(rng, m, B, nsyms, osr, amble, shifts)
    lengths = np.array([nsyms, 80, 96, 41, nsyms]) * osr - [0, 0, 1, 2, 0]
    for b in range(B):
        x[b, lengths[b]:] = 10.0 * (rng.standard_normal(x.shape[1]
                                                        - lengths[b]))
    jdem = jd.DemodulatorBatchQPSK()
    tdem = td.DemodulatorBatchQPSK(device="cpu")
    # preamble in the QPSK comparator convention: decide it once
    amble_q = tdem.demod_batch(torch.from_numpy(x[:1]), osr, amble, 0, 8,
                               n_out).syms[0, :alen].numpy()
    ref = jdem.demod_batch(jnp.asarray(x), osr, jnp.asarray(amble_q), 0, 8,
                           n_out, lengths=lengths)
    got = tdem.demod_batch(torch.from_numpy(x), osr, amble_q, 0, 8, n_out,
                           lengths=torch.from_numpy(lengths))
    for b in range(B):
        _assert_batch_equal(got, ref, rows=b)
    assert got.best_idx.tolist() == shifts.tolist() == np.asarray(
        ref.best_idx).tolist()
    # each row is the single-burst chain on its truncated burst
    for b in range(B):
        n_b = lengths[b] // osr * osr
        single = td.SimpleDemodulatorQPSK(device="cpu")
        syms = single.demod(torch.from_numpy(x[b, :n_b]), osr)
        slen = min(8, syms.shape[0] - alen + 1)
        rotated, sample, rotation, best = single.amble_rotate(
            amble_q, search=np.arange(slen))
        assert int(sample) == int(got.best_idx[b])
        assert int(rotation) == int(got.best_rotations[b])
        cut = rotated[int(sample) + alen: int(sample) + alen + n_out]
        assert int(got.bit_counts[b]) == cut.shape[0]
        bits = td.unpack_to_binary_bytes(single.syms_to_bits(cut).numpy(),
                                         4).reshape(-1)
        np.testing.assert_array_equal(got.bits[b, :bits.size].numpy(), bits)
        assert not got.bits[b, bits.size:].any()


def test_batch_demod_honours_a_custom_bitmap(rng):
    """The port's batch chain maps payload bits through its bitmap, so a
    row equals the port's single-burst chain; the JAX batch chain ignores
    the bitmap (ROADMAP Queue 3 item 10) and differs."""
    m, osr, nsyms, B, alen, n_out = 4, 4, 96, 3, 16, 64
    bitmap = np.array([0b00, 0b01, 0b11, 0b10], np.uint8)
    amble = rng.integers(0, m, alen)
    x = _batch_scene(rng, m, B, nsyms, osr, amble, [4, 4, 4])
    tdem = td.DemodulatorBatchQPSK(bitmap=bitmap, device="cpu")
    amble_q = tdem.demod_batch(torch.from_numpy(x[:1]), osr, amble, 0, 8,
                               n_out).syms[0, 4: 4 + alen].numpy()
    got = tdem.demod_batch(torch.from_numpy(x), osr, amble_q, 0, 8, n_out)
    ref = jd.DemodulatorBatchQPSK(bitmap=bitmap).demod_batch(
        jnp.asarray(x), osr, jnp.asarray(amble_q), 0, 8, n_out)
    default = td.DemodulatorBatchQPSK(device="cpu").demod_batch(
        torch.from_numpy(x), osr, amble_q, 0, 8, n_out)
    np.testing.assert_array_equal(default.bits.numpy(), np.asarray(ref.bits))
    assert not np.array_equal(got.bits.numpy(), np.asarray(ref.bits))
    for b in range(B):
        single = td.SimpleDemodulatorQPSK(bitmap=bitmap, device="cpu")
        single.demod(torch.from_numpy(x[b]), osr)
        rotated, sample, _, _ = single.amble_rotate(amble_q,
                                                    search=np.arange(8))
        cut = rotated[int(sample) + alen: int(sample) + alen + n_out]
        bits = td.unpack_to_binary_bytes(single.syms_to_bits(cut).numpy(),
                                         4).reshape(-1)
        np.testing.assert_array_equal(got.bits[b].numpy(), bits)


# -- CPFSK and ML demod -------------------------------------------------------

def _cpfsk_burst(rng, nbits, up, h=0.5):
    bits = rng.integers(0, 2, nbits).astype(np.uint8)
    sig, _, _ = make_cpfsk_syms(jnp.asarray(bits), 100.0, h=h, up=up,
                                dtype=jnp.complex128)
    return bits, np.asarray(sig)


def test_demodulate_cp2fsk_matches_jax(rng):
    bits, sig = _cpfsk_burst(rng, 200, 8)
    sig = (sig + 0.1 * _constellation_points(rng, sig.size)).astype(
        np.complex64)
    b_t, c_t, t_t = td.demodulate_cp2fsk(torch.from_numpy(sig), 0.5, 8)
    b_j, c_j, t_j = jd.demodulate_cp2fsk(jnp.asarray(sig), 0.5, 8)
    np.testing.assert_array_equal(b_t.numpy(), np.asarray(b_j))
    np.testing.assert_array_equal(b_t.numpy(), bits)
    np.testing.assert_allclose(t_t.numpy(), np.asarray(t_j), atol=1e-6)
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), rtol=1e-5)


def test_bursty_cp2fsk_matches_jax(rng):
    up, burst_len, guard_len, nb, offset = 8, 40, 10, 3, 25
    pieces, all_bits = [np.zeros(offset)], []
    for _ in range(nb):
        bits, sig = _cpfsk_burst(rng, burst_len, up)
        all_bits.append(bits)
        pieces += [sig, np.zeros(guard_len * up)]
    x = np.concatenate(pieces).astype(np.complex64)
    x = x + (0.05 * _constellation_points(rng, x.size))
    jb = jd.BurstyDemodulatorCP2FSK(burst_len, guard_len, up=up)
    tb = td.BurstyDemodulatorCP2FSK(burst_len, guard_len, up=up)
    d_j, mi_j = jb.demod(jnp.asarray(x), nb)
    d_t, mi_t = tb.demod(torch.from_numpy(x), nb)
    assert int(mi_t) == int(mi_j) == offset
    np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_j))
    np.testing.assert_array_equal(d_t.numpy(), np.stack(all_bits))
    np.testing.assert_allclose(tb.d_costs.numpy(), np.asarray(jb.d_costs),
                               rtol=1e-5)
    np.testing.assert_array_equal(tb.search_idx, jb.search_idx)


def test_ml_demod_qpsk_matches_jax(rng):
    up, num_syms = 4, 5
    truth = np.array([0, 3, 1, 2, 2], np.uint8)
    h = np.array([1.0, 0.8, 0.5, 0.2])
    ups = np.zeros(num_syms * up, complex)
    ups[::up] = np.exp(1j * truth * np.pi / 2)
    y = np.convolve(h, ups)[up: up + num_syms * up - up]
    y = (y + 0.05 * _constellation_points(rng, y.size)).astype(np.complex64)
    mm_t, ii_t, cost_t = td.ml_demod_qpsk(torch.from_numpy(y), h, up,
                                          num_syms)
    mm_j, ii_j, cost_j = jd.ml_demod_qpsk(jnp.asarray(y), jnp.asarray(h), up,
                                          num_syms)
    assert ii_t == ii_j
    np.testing.assert_array_equal(mm_t, mm_j)
    np.testing.assert_array_equal(mm_t[1:], truth[1:])
    np.testing.assert_allclose(cost_t.numpy(), np.asarray(cost_j), rtol=1e-5)


def test_demodulators_check_the_input_device():
    dem = td.SimpleDemodulatorQPSK(device="cpu")
    dem.device = torch.device("meta")
    with pytest.raises(ValueError, match="demodulator on meta"):
        dem.demod(torch.zeros(16, dtype=torch.complex64), 4)
    with pytest.raises(ValueError, match="unknown variant"):
        td.DemodulatorBatchPSK(4, "16qam", device="cpu")


def test_a_demodulator_owns_its_bitmap():
    """Editing a demodulator's bitmap in place leaves the shared table and
    other demodulators alone."""
    for dem in (td.SimpleDemodulatorQPSK(device="cpu"),
                td.DemodulatorBatchQPSK(device="cpu")):
        dem.bitmap[0] = 7
    np.testing.assert_array_equal(td.PSK_BITMAPS[4], [3, 1, 0, 2])
    assert td.SimpleDemodulatorPSK(4, device="cpu").bitmap.tolist() == [
        3, 1, 0, 2]

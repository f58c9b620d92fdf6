"""The port's ops/detection against the JAX package's, case for case with
tests/test_detection.py.

Scenes are made once with the JAX generators or numpy and handed to both as
numpy arrays. Edges, peaks and counts must be equal slot for slot (exact
int32); median-filtered power bit-equal; kmeans codebooks, noise means and
section metrics within rtol 1e-5 (float32 sums taken in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pydsproutines_tpu.ops.detection as JD
import pydsproutines_tpu_torch.ops.detection as TD
from pydsproutines_tpu.signal import add_sig_to_noise, rand_psk_syms


def _t(a):
    return torch.from_numpy(np.array(a))


def _same_edges(te, je):
    for a, b in zip(te, je):
        assert a.dtype == torch.int32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("x,thr,cap,lo,hi", [
    ([0, 0, 5, 5, 5, 0, 0, 7, 7, 0], 1.0, 4, 0, 2**31 - 1),     # basic
    ([0, 5, 0, 7, 7, 7, 0, 9, 9, 0], 1.0, 4, 2, 2),             # length limits
    ([0, 0, 3, 3, 3], 1.0, 2, 0, 2**31 - 1),                    # open at end
    ([5, 0, 5, 0, 5, 0, 5, 0, 5], 1.0, 3, 0, 2**31 - 1),        # > capacity
    ([5, 5, 0, 5, 0, 5, 5, 5], 1.0, 3, 2, 2**31 - 1),           # compaction
    ([0, 0, 0], 1.0, 2, 0, 2**31 - 1),                          # no run
])
def test_threshold_edges_matches_jax(x, thr, cap, lo, hi):
    x = np.asarray(x, dtype=np.float32)
    te = TD.threshold_edges(_t(x), thr, cap, lo, hi)
    je = JD.threshold_edges(jnp.asarray(x), thr, cap, lo, hi)
    _same_edges(te, je)


def test_threshold_edges_basic_values():
    x = _t(np.array([0, 0, 5, 5, 5, 0, 0, 7, 7, 0], dtype=np.float32))
    e = TD.threshold_edges(x, 1.0, capacity=4)
    assert int(e.count) == 2
    assert e.starts[:2].tolist() == [2, 7] and e.ends[:2].tolist() == [5, 9]
    assert int(e.starts[2]) == int(e.ends[2]) == -1


@pytest.mark.parametrize("seed", range(6))
def test_threshold_edges_random_runs_match_jax(seed):
    rng = np.random.default_rng(seed)
    x = (rng.random(400) < 0.35 + 0.1 * seed).astype(np.float32)
    x = np.convolve(x, np.ones(3), "same").astype(np.float32)
    cap = [4, 16, 64, 128, 7, 200][seed]
    te = TD.threshold_edges(_t(x), 1.5, cap, seed % 3, 8 + 4 * seed)
    je = JD.threshold_edges(jnp.asarray(x), 1.5, cap, seed % 3, 8 + 4 * seed)
    _same_edges(te, je)


def test_find_local_maxima_matches_jax():
    x = np.array([0, 2, 1, 5, 1, 0.5, 3, 0], dtype=np.float32)
    idx, count = TD.find_local_maxima(_t(x), 1.5, 4)
    jidx, jcount = JD.find_local_maxima(jnp.asarray(x), 1.5, 4)
    assert int(count) == int(jcount) == 3
    assert idx.dtype == torch.int32
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    idx2, count2 = TD.find_local_maxima(_t(x), 0.0, 2)      # > capacity
    jidx2, jcount2 = JD.find_local_maxima(jnp.asarray(x), 0.0, 2)
    assert int(count2) == int(jcount2)
    np.testing.assert_array_equal(idx2.numpy(), np.asarray(jidx2))


def _two_burst_scene(key):
    k1, k2, k3 = jax.random.split(key, 3)
    s1, _ = rand_psk_syms(k1, 500, 4, dtype=jnp.complex64)
    s2, _ = rand_psk_syms(k2, 700, 4, dtype=jnp.complex64)
    n = 5000
    _, rx = add_sig_to_noise(k3, s1 * 3, noise_len=n, sig_start_idx=1000,
                             snr_inband_linear=1.0)
    rx = rx + jax.lax.dynamic_update_slice(
        jnp.zeros(n, rx.dtype), (s2 * 3).astype(rx.dtype), (3000,))
    return np.asarray(rx)


def test_burst_detector_end_to_end_matches_jax(key):
    rx = _two_burst_scene(key)
    jbd = JD.BurstDetector(medfiltlen=65)
    jmf = np.asarray(jbd.medfilt(jnp.asarray(rx)))
    je = jbd.detect_via_threshold(threshold=4.0, capacity=16, min_length=200)
    tbd = TD.BurstDetector(medfiltlen=65)
    tmf = tbd.medfilt(_t(rx))
    np.testing.assert_array_equal(tmf.numpy(), jmf)
    te = tbd.detect_via_threshold(threshold=4.0, capacity=16, min_length=200)
    _same_edges(te, je)
    count = int(te.count)
    assert count == 2
    starts, ends = te.starts[:count].numpy(), te.ends[:count].numpy()
    assert abs(starts[0] - 1000) < 80 and abs(ends[0] - 1500) < 80
    assert abs(starts[1] - 3000) < 80 and abs(ends[1] - 3700) < 80


def test_burst_detector_carried_from_jax(key):
    """A JAX detector's state, carried by from_numpy_params, gives the same
    edges in the port."""
    rx = _two_burst_scene(key)
    jbd = JD.BurstDetector(medfiltlen=65)
    jbd.medfilt(jnp.asarray(rx))
    je = jbd.detect_via_threshold(threshold=4.0, capacity=16, min_length=200)
    tbd = TD.BurstDetector.from_numpy_params(
        {"medfiltlen": jbd.medfiltlen, "amp_sq": np.asarray(jbd.amp_sq),
         "medfiltered": np.asarray(jbd.medfiltered),
         "threshold": jbd.threshold})
    assert tbd.threshold == 4.0 and tbd.medfiltlen == 65
    _same_edges(tbd.detect_via_threshold(4.0, capacity=16, min_length=200), je)
    with pytest.raises(ValueError, match="medfilt"):
        TD.BurstDetector(5).detect_via_threshold(1.0)
    with pytest.raises(ValueError, match="odd"):
        TD.BurstDetector(64)


def test_auto_detect_threshold_matches_jax(key):
    k1, k2 = jax.random.split(key)
    s, _ = rand_psk_syms(k1, 2000, 4, dtype=jnp.complex64)
    _, rx = add_sig_to_noise(k2, s * 4, noise_len=10000, sig_start_idx=4000,
                             snr_inband_linear=1.0)
    rx = np.asarray(rx)
    levels = np.arange(0.0, 20.0, 0.5)
    jbd = JD.BurstDetector(medfiltlen=65)
    jbd.medfilt(jnp.asarray(rx))
    jthr = jbd.auto_detect_threshold(levels)
    tbd = TD.BurstDetector(medfiltlen=65)
    tbd.medfilt(_t(rx))
    thr = tbd.auto_detect_threshold(levels)
    assert thr is not None and thr == jthr
    assert 0.5 < thr < 16.0
    te = tbd.detect_via_threshold(thr, capacity=8, min_length=500)
    _same_edges(te, jbd.detect_via_threshold(jthr, capacity=8,
                                             min_length=500))
    assert int(te.count) >= 1
    assert tbd.auto_detect_threshold(levels, multiplier=2.0) == 2 * thr


def test_histogram_counts_follow_numpy_edge_rules():
    """Non-uniform edges, values on inner edges and exactly on the last
    edge (closed on the right), values outside the edges dropped."""
    edges = np.array([0.0, 0.1, 0.25, 1.0, 3.5, 4.0])
    v = np.array([-1.0, 0.0, 0.05, 0.1, 0.2, 0.25, 0.9, 1.0, 3.5, 3.9, 4.0,
                  4.0001, 7.0], dtype=np.float32)
    got = TD.histogram_counts(_t(v), edges)
    np.testing.assert_array_equal(got, np.histogram(v, bins=edges)[0])
    jcounts, _ = jnp.histogram(jnp.asarray(v), bins=jnp.asarray(edges))
    np.testing.assert_array_equal(got, np.asarray(jcounts))
    rng = np.random.default_rng(3)
    w = rng.exponential(1.0, 5000).astype(np.float32)
    e2 = np.concatenate([[0.0], np.geomspace(1e-2, 5.0, 30)])
    np.testing.assert_array_equal(TD.histogram_counts(_t(w), e2),
                                  np.histogram(w, bins=e2)[0])
    # no strict local minimum: None, as in the JAX package
    flat = np.full(100, 2.0, np.float32)
    assert TD.auto_detect_threshold(_t(flat), edges) is None
    assert JD.auto_detect_threshold(jnp.asarray(flat), edges) is None


def test_kmeans2_matches_jax(rng):
    x = np.concatenate([rng.normal(1.0, 0.1, 500),
                        rng.normal(10.0, 0.5, 100)]).astype(np.float32)
    lo, hi = TD.kmeans2(_t(x), 1.5, 9.0)
    jlo, jhi = JD.kmeans2(jnp.asarray(x), 1.5, 9.0)
    assert abs(float(lo) - 1.0) < 0.2 and abs(float(hi) - 10.0) < 0.5
    np.testing.assert_allclose([float(lo), float(hi)],
                               [float(jlo), float(jhi)], rtol=1e-5)
    assert lo.dtype == torch.float32


def test_energy_detection_matches_jax(key):
    k1, k2 = jax.random.split(key)
    s, _ = rand_psk_syms(k1, 1000, 4, dtype=jnp.complex64)
    _, rx = add_sig_to_noise(k2, s * 4, noise_len=8000, sig_start_idx=5000,
                             snr_inband_linear=1.0)
    amp_sq = (np.abs(np.asarray(rx)) ** 2).astype(np.float32)
    for noise in (np.arange(4000), None):           # default: first 100k
        got = TD.energy_detection(_t(amp_sq), 65, snr_req_linear=4.0,
                                  noise_indices=noise)
        ref = JD.energy_detection(
            jnp.asarray(amp_sq), 65, snr_req_linear=4.0,
            noise_indices=None if noise is None else jnp.asarray(noise))
        np.testing.assert_allclose(float(got[0]), float(ref[0]), rtol=1e-5)
        np.testing.assert_allclose(float(got[1]), float(ref[1]), rtol=1e-5)
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))
        _same_edges(got[3], ref[3])
    mean_noise, _, _, edges = TD.energy_detection(
        _t(amp_sq), 65, snr_req_linear=4.0, noise_indices=np.arange(4000))
    assert abs(float(mean_noise) - 1.0) < 0.3
    assert int(edges.count) >= 1 and abs(int(edges.starts[0]) - 5000) < 100


def test_detect_single_emitter_matches_jax(rng):
    x = rng.normal(0, 0.3, 6000).astype(np.float32)
    x[1500:2600] += rng.normal(0, 3.0, 1100).astype(np.float32)
    x[4000:4400] += rng.normal(0, 3.0, 400).astype(np.float32)
    jbd = JD.BurstDetector(medfiltlen=31)
    jbd.medfilt(jnp.asarray(x))
    je = jbd.detect_single_emitter(capacity=8, min_length=100)
    tbd = TD.BurstDetector(medfiltlen=31)
    tbd.medfilt(_t(x))
    te = tbd.detect_single_emitter(capacity=8, min_length=100)
    np.testing.assert_allclose(float(tbd.threshold), float(jbd.threshold),
                               rtol=1e-5)
    _same_edges(te, je)
    assert int(te.count) >= 1


def test_detect_regular_sections_matches_jax(rng):
    period, burst = 1000, 300
    n = 20 * period
    x = rng.normal(0, 0.1, n).astype(np.float32)
    for s in range(0, n, period):
        x[s:s + burst] += rng.normal(0, 3.0, burst).astype(np.float32)
    sizes = np.array([700, 850, 1000, 1150, 1300])
    tbd = TD.BurstDetector(medfiltlen=31)
    tbd.medfilt(_t(x))
    metric, codebooks = tbd.detect_regular_sections(sizes)
    jbd = JD.BurstDetector(medfiltlen=31)
    jbd.medfilt(jnp.asarray(x))
    jmetric, jcodebooks = jbd.detect_regular_sections(sizes)
    assert metric.shape == (5, 2) and codebooks.shape == (5, 2)
    assert sizes[np.argmax(metric[:, 0])] == period
    assert np.all(codebooks[:, 1] >= codebooks[:, 0])
    np.testing.assert_allclose(metric, jmetric, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(codebooks, jcodebooks, rtol=1e-5, atol=1e-7)

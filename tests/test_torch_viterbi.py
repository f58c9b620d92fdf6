"""Parity of the PyTorch Viterbi demodulators with the JAX package.

The same numpy inputs go to both packages (complex64, on the CPU). Survivor
paths and route choices must be equal; path metrics within rtol 1e-4 (the
JAX tests' own tolerance, tests/test_viterbi.py). Both packages form the
phase exp(-1j*omega*t) from a float32 t. The numpy reference trellis and
the brute-force window-state MLSE of tests/test_viterbi.py are copied here
as independent oracles.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pydsproutines_tpu.ops import viterbi as jv
from pydsproutines_tpu_torch.ops import viterbi as tv

RTOL = 1e-4


def _np_viterbi_reference(alphabet, pretransitions, pulses, omegas, up, y,
                          pathlen, allowed_start=(0,)):
    """Direct numpy re-derivation of the reference trellis
    (viterbiDemodClasses.py:53-254)."""
    A = len(alphabet)
    L = pulses.shape[0]
    pulselen = pulses.shape[1]
    omegavecs = np.exp(1j * (-omegas[:, None] * np.arange(len(y) + pulselen)))

    paths = np.zeros((A, pathlen), dtype=alphabet.dtype)
    pathmetrics = np.full(A, np.inf)
    for a in range(A):
        if a not in allowed_start:
            continue
        paths[a, 0] = alphabet[a]
        xall = np.zeros((L, pulselen), dtype=complex)
        for i in range(L):
            xc = np.convolve(pulses[i], paths[a, :1])[-pulselen:]
            xall[i] = np.exp(1j * (-omegas[i] * np.arange(pulselen))) * xc
        summed = xall.sum(axis=0)
        pathmetrics[a] = np.linalg.norm(y[:up] - summed[:up]) ** 2

    for n in range(1, pathlen):
        branch = np.zeros(pretransitions.shape)
        shortb = np.zeros_like(branch)
        for p in range(A):
            for t in range(pretransitions.shape[1]):
                q = pretransitions[p, t]
                if pathmetrics[q] == np.inf:
                    branch[p, t] = np.inf
                    shortb[p, t] = np.inf
                    continue
                guess = paths[q].copy()
                guess[n] = alphabet[p]
                upguess = np.zeros(pathlen * up, dtype=complex)
                upguess[::up] = guess
                s = max(n * up - pulselen + 1, 0)
                xall = np.zeros((L, pulselen), dtype=complex)
                for i in range(L):
                    pad = np.pad(upguess[s: n * up + 1], (0, pulselen - 1))
                    # scipy-lfilter equivalent: full conv truncated to input len
                    xc = np.convolve(pulses[i], pad)[: len(pad)][-pulselen:]
                    xall[i] = omegavecs[i, n * up: n * up + pulselen] * xc
                summed = xall.sum(axis=0)
                yseg = y[up * n: up * n + pulselen]
                branch[p, t] = np.linalg.norm(yseg - summed[: len(yseg)]) ** 2
                shortb[p, t] = np.linalg.norm(
                    y[up * n: up * (n + 1)] - summed[:up]) ** 2
        temppaths = paths.copy()
        tempmetrics = pathmetrics.copy()
        for p in range(A):
            if np.all(branch[p] == np.inf):
                tempmetrics[p] = np.inf
                continue
            bt = np.argmin(branch[p])
            temppaths[p] = paths[pretransitions[p, bt]]
            temppaths[p, n] = alphabet[p]
            tempmetrics[p] = pathmetrics[pretransitions[p, bt]] + shortb[p, bt]
        paths = temppaths
        pathmetrics = tempmetrics

    best = np.argmin(pathmetrics)
    return paths[best], pathmetrics, paths


def _np_window_mlse(alphabet, pre, pulses, omegas, up, y, pathlen,
                    allowed_start=(0,)):
    """Brute-force exact MLSE over the (A+1)^k window-state trellis."""
    A = len(alphabet)
    base = A + 1
    pulselen = pulses.shape[1]
    k = pulselen // up
    codes = base ** k

    def bm_short(n, c):
        digs = [(c // base ** (k - 1 - i)) % base for i in range(k)]
        w = np.array([0 if d == 0 else alphabet[d - 1] for d in digs])
        ups = np.zeros(k * up, complex)
        ups[::up] = w
        seg = np.zeros(pulselen, complex)
        for i in range(pulses.shape[0]):
            cv = np.convolve(ups, pulses[i])
            s = cv[(k - 1) * up: (k - 1) * up + pulselen]
            t = n * up + np.arange(pulselen)
            seg += s * np.exp(-1j * omegas[i] * t)
        yseg = np.zeros(pulselen, complex)
        avail = y[n * up: n * up + pulselen]
        yseg[: len(avail)] = avail
        valid = (n * up + np.arange(pulselen)) < len(y)
        d = np.where(valid, yseg - seg, 0)
        return np.sum(np.abs(d[:up]) ** 2)

    hist = np.full((pathlen, codes), np.inf)
    back = np.zeros((pathlen, codes), np.int32)
    for a in allowed_start:
        hist[0, a + 1] = bm_short(0, a + 1)
    for n in range(1, pathlen):
        for cp in range(codes):
            dnew = cp % base
            if dnew == 0:
                continue
            p = dnew - 1
            tailc = cp // base
            dq = tailc % base
            if dq == 0 or (dq - 1) not in pre[p]:
                continue
            best, barg = np.inf, 0
            for u in range(base):
                c = u * base ** (k - 1) + tailc
                if hist[n - 1, c] < best:
                    best, barg = hist[n - 1, c], c
            if best < np.inf:
                hist[n, cp] = best + bm_short(n, cp)
                back[n, cp] = barg
    metrics = np.full(A, np.inf)
    paths = np.zeros((A, pathlen), np.int32)
    for p in range(A):
        group = [v * base + (p + 1) for v in range(base ** (k - 1))]
        j = int(np.argmin(hist[-1, group]))
        metrics[p] = hist[-1, group[j]]
        c = group[j]
        for m in range(pathlen - 1, -1, -1):
            paths[p, m] = (c % base) - 1
            c = back[m, c]
    return paths, metrics


def _make_cpm_setup():
    """4-phase-state CPM-ish setup: alphabet = 4 phases, transitions allow
    +/-1 phase steps, single source, rectangular pulse over 2 symbols."""
    A = 4
    alphabet = np.exp(1j * np.arange(A) * np.pi / 2).astype(np.complex64)
    pretransitions = np.array([[(p - 1) % A, (p + 1) % A] for p in range(A)],
                              dtype=np.int32)
    up = 4
    pulses = np.full((1, 2 * up), 0.5, dtype=np.complex64)
    omegas = np.array([0.05], dtype=np.float32)
    return alphabet, pretransitions, pulses, omegas, up


def _synthesize(alphabet_path, pulses, omegas, up, nsamps):
    ups = np.zeros(nsamps, dtype=complex)
    ups[: len(alphabet_path) * up: up] = alphabet_path
    y = np.zeros(nsamps, dtype=complex)
    for i in range(pulses.shape[0]):
        xc = np.convolve(pulses[i], ups)[:nsamps]
        y += xc * np.exp(1j * (-omegas[i] * np.arange(nsamps)))
    return y


def _walk(rng, pre, pathlen, first=0):
    """A state sequence that respects the pretransitions."""
    states = [first]
    for _ in range(pathlen - 1):
        succ = [p for p in range(pre.shape[0]) if states[-1] in pre[p]]
        states.append(int(succ[rng.integers(0, len(succ))]))
    return np.array(states)


def _noise(rng, n, scale=1.0):
    return scale * (rng.standard_normal(n) + 1j * rng.standard_normal(n))


def _pair(alphabet, pre, pulses, omegas, up, **kw):
    """The same demodulator in both packages, the port's built from the JAX
    instance's attributes."""
    j = jv.ViterbiDemodulator(alphabet, pre, pulses, omegas, up, **kw)
    t = tv.ViterbiDemodulator.from_numpy_params(
        {name: getattr(j, name) for name in
         ("alphabet", "pretransitions", "pulses", "omegas", "up",
          "allowed_start_idx", "survivor_metric")}, device="cpu")
    return j, t


def _assert_runs_equal(got, ref):
    best_t, metrics_t, vals_t = got
    best_j, metrics_j, vals_j = (np.asarray(v) for v in ref)
    np.testing.assert_array_equal(vals_t.numpy(), vals_j)
    np.testing.assert_array_equal(best_t.numpy(), best_j)
    np.testing.assert_array_equal(np.isinf(metrics_t.numpy()),
                                  np.isinf(metrics_j))
    fin = np.isfinite(metrics_j)
    np.testing.assert_allclose(metrics_t.numpy()[fin], metrics_j[fin],
                               rtol=RTOL)


def _args(y, alphabet, pre, pulses, omegas, start):
    return ((jnp.asarray(y), jnp.asarray(alphabet), jnp.asarray(pre),
             jnp.asarray(pulses), jnp.asarray(omegas), jnp.asarray(start)),
            (torch.from_numpy(y), torch.from_numpy(alphabet),
             torch.from_numpy(pre), torch.from_numpy(pulses),
             torch.from_numpy(omegas), torch.from_numpy(start)))


def test_gate_constants_and_viability_are_the_jax_package_s():
    assert (tv._ACS_MAX_STATES, tv._ACS_MAX_ELEMS) == (jv._ACS_MAX_STATES,
                                                       jv._ACS_MAX_ELEMS)
    for a, k, n in [(2, 2, 512), (2, 8, 512), (127, 1, 10 ** 6), (200, 1, 4),
                    (2, 4, 252), (2, 4, 253), (128, 1, 64), (128, 1, 65),
                    (4, 3, 68), (4, 3, 69), (2, 5, 12)]:
        assert tv._viterbi_acs_viable(a, k, n) == jv._viterbi_acs_viable(
            a, k, n), (a, k, n)


def test_matches_numpy_reference_on_noisy_input(rng):
    alphabet, pre, pulses, omegas, up = _make_cpm_setup()
    pathlen = 12
    nsamps = pathlen * up + pulses.shape[1]
    y = _noise(rng, nsamps)
    ref_path, ref_metrics, _ = _np_viterbi_reference(
        alphabet.astype(complex), pre, pulses.astype(complex),
        omegas.astype(float), up, y, pathlen)
    jd_, td_ = _pair(alphabet, pre, pulses, omegas, up)
    y32 = y.astype(np.complex64)
    got = td_.run(torch.from_numpy(y32), pathlen)
    _assert_runs_equal(got, jd_.run(jnp.asarray(y32), pathlen))
    np.testing.assert_allclose(got[1].numpy(), ref_metrics, rtol=RTOL)
    np.testing.assert_allclose(got[0].numpy(), ref_path, atol=1e-5)


@pytest.mark.parametrize("survivor,k_syms,route", [
    ("branch", 1, "branch-tables"), ("path", 1, "memoryless-acs"),
    ("path", 2, "path-acs"), ("branch", 2, "scan")])
def test_each_route_matches_jax_and_recovers_a_planted_path(
        rng, survivor, k_syms, route):
    """Multi-source pulses, a frequency offset each, two start states, a
    path that respects the transitions: the port takes the JAX package's
    route and returns its paths and metrics, on a clean scene and on
    noise."""
    A, up, pathlen = 4, 4, 40
    alphabet = np.exp(1j * 2 * np.pi * np.arange(A) / A).astype(np.complex64)
    pre = np.stack([np.roll(np.arange(A), 1),
                    np.roll(np.arange(A), -1)], axis=1).astype(np.int32)
    plen = k_syms * up
    pulses = np.stack([np.hanning(plen + 2)[1:-1] + 0.1,
                       0.3 * np.ones(plen)]).astype(np.complex64)
    omegas = np.array([0.03, -0.07], np.float32)
    start = np.array([0, 2])
    assert tv._viterbi_route(A, k_syms, pathlen, survivor, True) == route
    jd_, td_ = _pair(alphabet, pre, pulses, omegas, up,
                     allowed_start_idx=start, survivor_metric=survivor)
    truth = _walk(rng, pre, pathlen, first=2)
    nsamps = pathlen * up + plen
    clean = _synthesize(alphabet[truth], pulses, omegas, up, nsamps)
    for y in (clean + _noise(rng, nsamps, 0.02), _noise(rng, nsamps)):
        y = y.astype(np.complex64)
        got = td_.run(torch.from_numpy(y), pathlen)
        _assert_runs_equal(got, jd_.run(jnp.asarray(y), pathlen))
    got = td_.run(torch.from_numpy(
        (clean + _noise(rng, nsamps, 0.02)).astype(np.complex64)), pathlen)
    if survivor == "path" or k_syms > 1:
        np.testing.assert_allclose(got[0].numpy(), alphabet[truth],
                                   atol=1e-4)
    # the host tables are built once per path length and kept
    assert list(td_._tables) == [pathlen]


def test_memoryless_scan_routes_match_jax(rng):
    """The memoryless trellis without host tables (survivor "branch") and
    at pathlen 1 (survivor "path") takes the sequential scan in both
    packages."""
    up, A = 4, 4
    alphabet = np.exp(1j * 2 * np.pi * np.arange(A) / A).astype(np.complex64)
    pre = np.stack([np.roll(np.arange(A), 1),
                    np.roll(np.arange(A), -1)], axis=1).astype(np.int32)
    pulses = np.stack([np.hanning(up) + 0.1,
                       0.3 * np.ones(up)]).astype(np.complex64)
    omegas = np.array([0.0, 0.05], np.float32)
    start = np.array([True, False, True, False])
    for survivor, pathlen in (("branch", 37), ("path", 37), ("path", 1)):
        y = _noise(rng, pathlen * up).astype(np.complex64)
        ja, ta = _args(y, alphabet, pre, pulses, omegas, start)
        kw = dict(up=up, pulselen=up, pathlen=pathlen,
                  survivor_metric=survivor)
        p_j, m_j = jv._viterbi_run_memoryless(*ja, **kw)
        p_t, m_t = tv._viterbi_run_scan(*ta, k_syms=1, **kw)
        np.testing.assert_array_equal(p_t.numpy(), np.asarray(p_j))
        np.testing.assert_allclose(m_t.numpy(), np.asarray(m_j), rtol=RTOL)


@pytest.mark.parametrize("a,k_syms,pathlen,at_gate", [
    (2, 5, 12, None), (128, 1, 65, 64)])
def test_a_trellis_just_past_the_size_gate_takes_the_scan(rng, a, k_syms,
                                                          pathlen, at_gate):
    """243 window states (past _ACS_MAX_STATES = 128), and 128 memoryless
    states at pathlen 65 (65 * 128^3 past _ACS_MAX_ELEMS = 2^27; pathlen 64
    is on the gate): survivor "path" falls back to the general scan in both
    packages, with equal paths."""
    up = 2
    alphabet = np.exp(1j * 2 * np.pi * np.arange(a) / a).astype(np.complex64)
    pre = np.stack([np.roll(np.arange(a), 1),
                    np.roll(np.arange(a), -1)], axis=1).astype(np.int32)
    pulses = np.full((1, k_syms * up), 0.5, np.complex64)
    omegas = np.array([0.02], np.float32)
    assert not jv._viterbi_acs_viable(a, k_syms, pathlen)
    assert tv._viterbi_route(a, k_syms, pathlen, "path", True) == "scan"
    if at_gate:
        assert tv._viterbi_route(a, k_syms, at_gate, "path",
                                 True) == "memoryless-acs"
    jd_, td_ = _pair(alphabet, pre, pulses, omegas, up,
                     survivor_metric="path")
    truth = _walk(rng, pre, pathlen)
    y = (_synthesize(alphabet[truth], pulses, omegas, up, pathlen * up)
         + _noise(rng, pathlen * up, 0.01)).astype(np.complex64)
    got = td_.run(torch.from_numpy(y), pathlen)
    _assert_runs_equal(got, jd_.run(jnp.asarray(y), pathlen))
    np.testing.assert_allclose(got[0].numpy(), alphabet[truth], atol=1e-4)


def test_path_acs_matches_bruteforce_mlse(rng):
    """k_syms = 2 MLSE on the min-plus chain vs the brute-force window-state
    Viterbi and the JAX route."""
    alphabet, pre, pulses, omegas, up = _make_cpm_setup()
    pathlen = 14
    nsamps = pathlen * up + pulses.shape[1]
    truth = _walk(rng, pre, pathlen)
    y = (_synthesize(alphabet[truth], pulses, omegas, up, nsamps)
         + _noise(rng, nsamps, 0.1)).astype(np.complex64)
    ref_paths, ref_metrics = _np_window_mlse(alphabet, pre, pulses, omegas,
                                             up, y, pathlen)
    jd_, td_ = _pair(alphabet, pre, pulses, omegas, up,
                     survivor_metric="path")
    got = td_.run(torch.from_numpy(y), pathlen)
    _assert_runs_equal(got, jd_.run(jnp.asarray(y), pathlen))
    fin = np.isfinite(ref_metrics)
    np.testing.assert_allclose(got[1].numpy()[fin], ref_metrics[fin],
                               rtol=2e-4)
    assert np.all(np.isinf(got[1].numpy()[~fin]))
    best = int(np.argmin(ref_metrics))
    np.testing.assert_array_equal(got[0].numpy(), alphabet[ref_paths[best]])


def test_path_acs_pathlen_one_gives_the_first_symbol_metrics(rng):
    """pathlen == 1 on both path-ACS routes (the JAX chain reads the last
    step of an empty axis there): the metrics are the first symbol's, as
    the brute-force MLSE and the sequential scan give them, and each path is
    its one final state."""
    alphabet, pre, pulses, omegas, up = _make_cpm_setup()
    y = _noise(rng, 3 * up).astype(np.complex64)
    start = np.array([True, True, False, True])
    ref_paths, ref_metrics = _np_window_mlse(
        alphabet, pre, pulses, omegas, up, y, 1, allowed_start=(0, 1, 3))
    ps = tuple(map(tuple, pre.tolist()))
    ss = tuple(bool(v) for v in start)
    _, ta = _args(y, alphabet, pre, pulses, omegas, start)
    assert tv._viterbi_route(4, 2, 1, "path", True) == "path-acs"
    p_t, m_t = tv._viterbi_run(*ta, up=up, pulselen=2 * up, k_syms=2,
                               pathlen=1, survivor_metric="path",
                               pret_static=ps, start_static=ss)
    np.testing.assert_array_equal(p_t.numpy(), ref_paths)
    np.testing.assert_array_equal(np.isinf(m_t.numpy()), ~start)
    np.testing.assert_allclose(m_t.numpy()[start], ref_metrics[start],
                               rtol=RTOL)
    for k_syms in (1, 2):
        plen = k_syms * up
        bp, bm = tv.viterbi_path_acs_batch(
            torch.from_numpy(np.stack([y, 2 * y])), alphabet, pre,
            pulses[:, :plen], omegas, start, up=up, pulselen=plen,
            k_syms=k_syms, pathlen=1, pret_static=ps, start_static=ss)
        for b, yb in enumerate((y, 2 * y)):
            ja, _ = _args(yb, alphabet, pre, pulses[:, :plen], omegas, start)
            p_s, m_s = jv._viterbi_run_scan(*ja, up=up, pulselen=plen,
                                            k_syms=k_syms, pathlen=1,
                                            survivor_metric="path")
            assert bp.shape == (2, 4, 1)
            np.testing.assert_array_equal(bp[b].numpy(), np.asarray(p_s))
            assert np.all(np.isfinite(bm[b].numpy()[start]))
            np.testing.assert_allclose(bm[b].numpy(), np.asarray(m_s),
                                       rtol=RTOL)


def test_batched_acs_matches_jax_and_per_burst_runs(rng):
    """viterbi_path_acs_batch equals the JAX batch call and the port's
    per-burst dispatcher, for k_syms = 1 and 2, on noise and a ragged burst
    (one shorter than pathlen * up)."""
    alphabet = np.array([1.0, -1.0], dtype=np.complex64)
    pre = np.array([[0, 1], [0, 1]], dtype=np.int32)
    up, nsyms, B = 8, 48, 4
    pulse2 = np.full((1, 2 * up), 0.5, dtype=np.complex64)
    omegas = np.array([0.05], dtype=np.float32)
    start = np.array([True, True])
    ps, ss = ((0, 1), (0, 1)), (True, True)
    ys = _noise(rng, (B, nsyms * up)).astype(np.complex64)
    for k_syms in (2, 1):
        pl_ = pulse2[:, : k_syms * up]
        kw = dict(up=up, pulselen=k_syms * up, k_syms=k_syms, pathlen=nsyms,
                  pret_static=ps, start_static=ss)
        bp_j, bm_j = jv.viterbi_path_acs_batch(
            jnp.asarray(ys), jnp.asarray(alphabet), jnp.asarray(pre),
            jnp.asarray(pl_), jnp.asarray(omegas), jnp.asarray(start), **kw)
        bp, bm = tv.viterbi_path_acs_batch(
            torch.from_numpy(ys), alphabet, pre, pl_, omegas, start, **kw)
        assert bp.dtype == torch.int32 and bp.shape == (B, 2, nsyms)
        np.testing.assert_array_equal(bp.numpy(), np.asarray(bp_j))
        np.testing.assert_allclose(bm.numpy(), np.asarray(bm_j), rtol=RTOL)
        for b in range(B):
            _, ta = _args(ys[b], alphabet, pre, pl_, omegas, start)
            paths, metrics = tv._viterbi_run(*ta, survivor_metric="path",
                                             **kw)
            np.testing.assert_array_equal(bp[b].numpy(), paths.numpy())
            np.testing.assert_allclose(bm[b].numpy(), metrics.numpy(),
                                       rtol=RTOL)
        short = ys[:1, : nsyms * up - 37]
        p_s, m_s = tv.viterbi_path_acs_batch(
            torch.from_numpy(short), alphabet, pre, pl_, omegas, start, **kw)
        p_j, m_j = jv.viterbi_path_acs_batch(
            jnp.asarray(short), jnp.asarray(alphabet), jnp.asarray(pre),
            jnp.asarray(pl_), jnp.asarray(omegas), jnp.asarray(start), **kw)
        np.testing.assert_array_equal(p_s.numpy(), np.asarray(p_j))
        np.testing.assert_allclose(m_s.numpy(), np.asarray(m_j), rtol=RTOL)
    with pytest.raises(ValueError, match="survivor_metric='path'"):
        tv.viterbi_path_acs_batch(torch.from_numpy(ys), alphabet, pre, pl_,
                                  omegas, start, survivor_metric="branch",
                                  **kw)


def test_minplus_chain_matches_a_sequential_min_plus_scan(rng):
    """The three-phase chain (pairwise tree, block scan, replay; index maps
    composed the same way) against the plain per-step recursion, at lengths
    on and off the 16-step block."""
    S, B = 5, 3
    candc = torch.tensor([[(s + d) % S for d in (-1, 0, 2)]
                          for s in range(S)])
    legc = torch.ones_like(candc, dtype=torch.bool)
    legc[0, 2] = False
    adj = torch.full((S, S), float("inf"))
    for s in range(S):
        for u in range(3):
            if legc[s, u]:
                adj[s, candc[s, u]] = 0.0
    for N in (2, 16, 17, 40):
        bm = torch.from_numpy(rng.uniform(0, 4, (B, N, S)).astype(np.float32))
        m0 = bm[:, 0].clone()
        m0[:, 1] = float("inf")
        metrics, codeseq = tv._minplus_chain_batched(
            bm[:, 1:, :, None] + adj, m0, candc, legc)
        m, back = m0, []
        for n in range(1, N):
            cand = torch.where(legc, m[:, candc], float("inf"))
            u = cand.argmin(-1)
            back.append(candc[torch.arange(S), u])
            m = cand.amin(-1) + bm[:, n]
        np.testing.assert_allclose(metrics.numpy(), m.numpy(), rtol=1e-6)
        s = torch.arange(S).expand(B, S)
        for n in range(N - 1, -1, -1):
            np.testing.assert_array_equal(codeseq[:, n].numpy(), s.numpy())
            if n:
                s = torch.gather(back[n - 1], 1, s)


def test_bursty_viterbi_matches_jax_and_recovers_the_bursts(rng):
    """Bursts of 10 symbols with 3 silent guard symbols: normal, guard and
    new-burst steps in one run, a pulse spanning 2 symbols."""
    alphabet = np.array([1.0, -1.0], np.complex64)
    pre = np.array([[0, 1], [0, 1]], np.int32)
    up, burst, guard, pathlen = 4, 10, 3, 36
    pulses = np.full((1, 2 * up), 0.5, np.complex64)
    omegas = np.array([0.02], np.float32)
    jb = jv.BurstyViterbiDemodulator(alphabet, pre, pulses, omegas, up,
                                     burst, guard)
    tb = tv.BurstyViterbiDemodulator.from_numpy_params(
        {name: getattr(jb, name) for name in
         ("alphabet", "pretransitions", "pulses", "omegas", "up",
          "allowed_start_idx", "num_burst_syms", "num_guard_syms")},
        device="cpu")
    active = (np.arange(pathlen) % (burst + guard)) < burst
    syms = np.where(active, alphabet[rng.integers(0, 2, pathlen)], 0)
    nsamps = pathlen * up + pulses.shape[1]
    clean = _synthesize(syms, pulses, omegas, up, nsamps)
    for y in (clean + _noise(rng, nsamps, 0.02), _noise(rng, nsamps)):
        y = y.astype(np.complex64)
        got = tb.run(torch.from_numpy(y), pathlen)
        _assert_runs_equal(got, jb.run(jnp.asarray(y), pathlen))
    got = tb.run(torch.from_numpy(
        (clean + _noise(rng, nsamps, 0.02)).astype(np.complex64)), pathlen)
    np.testing.assert_allclose(got[0].numpy(), syms, atol=1e-5)


def test_path_survivors_fix_the_memoryless_degeneracy(rng):
    """The reference's branch-only survivors degenerate on memoryless pulses
    (ties always to transition 0); "path" survivors decode a clean 2FSK
    stream. The port reproduces both, as the JAX package does."""
    up, pathlen = 8, 64
    alphabet = np.array([1.0, -1.0], dtype=np.complex64)
    kw = dict(pretransitions=np.array([[0, 1], [0, 1]], np.int32),
              pulses=np.ones((1, up), np.complex64),
              omegas=np.zeros(1, np.float32), up=up,
              allowed_start_idx=np.array([0, 1]))
    truth = rng.integers(0, 2, pathlen)
    y = torch.from_numpy(np.repeat(alphabet[truth], up))
    best, metrics, _ = tv.ViterbiDemodulator(
        alphabet, survivor_metric="path", device="cpu", **kw).run(y, pathlen)
    np.testing.assert_array_equal((best.real < 0).long().numpy(), truth)
    assert float(metrics.min()) < 1e-3
    best_b, _, _ = tv.ViterbiDemodulator(alphabet, device="cpu",
                                         **kw).run(y, pathlen)
    assert not np.array_equal((best_b.real < 0).long().numpy(), truth)


def test_constructor_checks_and_input_device():
    alphabet, pre, pulses, omegas, up = _make_cpm_setup()
    with pytest.raises(ValueError, match="survivor_metric"):
        tv.ViterbiDemodulator(alphabet, pre, pulses, omegas, up,
                              survivor_metric="soft", device="cpu")
    with pytest.raises(ValueError, match="transitions"):
        tv.ViterbiDemodulator(alphabet[:3], pre, pulses, omegas, up,
                              device="cpu")
    with pytest.raises(ValueError, match="sources"):
        tv.ViterbiDemodulator(alphabet, pre, pulses, omegas[[0, 0]], up,
                              device="cpu")
    with pytest.raises(ValueError, match="multiple of up"):
        tv.ViterbiDemodulator(alphabet, pre, pulses[:, :7], omegas, up,
                              device="cpu")
    vd = tv.ViterbiDemodulator(alphabet, pre, pulses, omegas, up,
                               device="cpu")
    vd.device = torch.device("meta")
    with pytest.raises(ValueError, match="demodulator on meta"):
        vd.run(torch.zeros(16, dtype=torch.complex64), 4)

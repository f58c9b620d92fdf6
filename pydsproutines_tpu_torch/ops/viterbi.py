"""Viterbi demodulation of multi-source CPM-like signals (reference
viterbiDemodClasses: ViterbiDemodulator, BurstyViterbiDemodulator).

PyTorch counterpart of ``pydsproutines_tpu/ops/viterbi.py``. States are the
alphabet symbols; each state keeps one survivor path. The branch metric from
predecessor q to state p at symbol step n is

    || y[n*up : n*up+pulselen] - sum_i pulse_i * upsampled(path) .
       exp(-j*omega_i*(n*up+k)) ||^2

and the path metric accumulates the short branch metric (the first ``up``
samples only). The routes are the JAX package's, chosen by the same gate
(:func:`_viterbi_route`):

* ``k_syms == 1`` (memoryless pulses): the branch metric depends only on
  (step, state), so every branch metric comes from one vectorized pass.
  Under "branch" survivors the control flow is data-independent and
  unrolls on the host into index tables (one gather and a sum on the
  device); under "path" survivors the recursion is a min-plus matrix
  chain.
* ``k_syms > 1`` with "path" survivors and a trellis under the size gate
  (``_ACS_MAX_STATES``, ``_ACS_MAX_ELEMS``): exact MLSE as a min-plus chain
  over the (A+1)^k_syms window-code trellis.
* otherwise the general scan: one vectorized step over (state, transition)
  per symbol.

The min-plus chain (:func:`_minplus_chain_batched`) keeps the JAX package's
three phases, so a chain of N symbols takes a few dozen launches, not N:
block matrices by a pairwise tree over 16 steps, a scan over the blocks,
then a replay inside all blocks at once; backtracking composes index maps
the same way. Bursts lead every tensor (the JAX "bursts-minor" layout is a
TPU lane rule).

No matrix product or convolution runs here: the pulse synthesis is explicit
shifted sums over the few symbols a pulse spans, so no TF32 path is
reachable on the card. Phases exp(-1j*omega*t) are formed from a float32
``t``, as the JAX package forms them.

``_viterbi_run_fast`` (the JAX package's table-driven scan) is not ported:
the dispatcher never reaches it, and ``_code_branch_tables`` carries its
table idea.
"""

from __future__ import annotations

import numpy as np
import torch

from pydsproutines_tpu_torch.utils.device import resolve_device
from pydsproutines_tpu_torch.utils.dtypes import to_tensor

_INF = float("inf")

# min-plus chain caps (the JAX package's constants): S = states in the
# min-plus recursion ((A+1)^k_syms for the pulse-memory MLSE, A for the
# memoryless path variant); a compose level touches ~pathlen * S^3 sums.
_ACS_MAX_STATES = 128
_ACS_MAX_ELEMS = 1 << 27        # pathlen * S^3 budget (f32 elements)

# steps a block of the min-plus chain reduces to one matrix
_KBL = 16


def _viterbi_acs_viable(a: int, k_syms: int, pathlen: int) -> bool:
    s = (a + 1) ** k_syms if k_syms > 1 else a
    return s <= _ACS_MAX_STATES and pathlen * s ** 3 <= _ACS_MAX_ELEMS


def _viterbi_route(a: int, k_syms: int, pathlen: int, survivor_metric: str,
                   static: bool) -> str:
    """The JAX dispatcher's choice (``_viterbi_run`` and
    ``_viterbi_run_memoryless``): "branch-tables", "memoryless-acs",
    "path-acs" or "scan". ``static``: the pretransitions and start states
    are known on the host."""
    if k_syms == 1:
        if survivor_metric == "branch" and static:
            return "branch-tables"
        if (survivor_metric == "path" and pathlen > 1
                and _viterbi_acs_viable(a, 1, pathlen)):
            return "memoryless-acs"
        return "scan"
    if survivor_metric == "path" and static and _viterbi_acs_viable(
            a, k_syms, pathlen):
        return "path-acs"
    return "scan"


# ---------------------------------------------------------------------------
# Host tables (numpy)
# ---------------------------------------------------------------------------

def _branch_idx_tables(pret: np.ndarray, start: np.ndarray, pathlen: int):
    """Host unroll of the faithful (branch-metric-only) survivor recursion
    for memoryless pulses. With k_syms == 1 the branch metric is identical
    across predecessors, so the survivor choice depends only on which
    predecessors are alive, and aliveness evolves data-independently
    (alive'[p] = any(alive[pret[p]])). Ties break to the first alive
    transition; dead states take pret[p, 0].

    Returns (idx, alive_final): idx[m, p] = survivor state at symbol m of
    the path ending in state p."""
    A, T = pret.shape
    alive = start.astype(bool).copy()
    bq = np.zeros((pathlen, A), np.int32)
    for n in range(1, pathlen):
        new_alive = np.zeros(A, bool)
        for p in range(A):
            ts = [t for t in range(T) if alive[pret[p, t]]]
            bq[n, p] = pret[p, ts[0] if ts else 0]
            new_alive[p] = bool(ts)
        alive = new_alive
    idx = np.zeros((pathlen, A), np.int32)
    idx[pathlen - 1] = np.arange(A)
    for m in range(pathlen - 1, 0, -1):
        idx[m - 1] = bq[m, idx[m]]
    return idx, alive


def _window_transitions(pret: np.ndarray, k_syms: int):
    """The (A+1)^k_syms window-code trellis: code c holds the last k_syms
    symbols, oldest first, digit 0 for pre-start silence and a+1 for
    alphabet[a]. c' = (c mod B^{k-1})*B + (p'+1) follows c when the newest
    digit of c is an allowed pretransition of p'. Returns (candc (C, B):
    the predecessor codes of each code, legc (C, B) their legality, adjc
    (C, C) float32 0 where legal else inf, group (A, B^{k-1}): the codes
    whose newest symbol is a)."""
    A = pret.shape[0]
    base = A + 1
    codes = base ** k_syms
    cvec = np.arange(codes)
    tail = cvec // base                                   # c' without newest
    candc = (np.arange(base)[None, :] * base ** (k_syms - 1)
             + tail[:, None]).astype(np.int64)            # (codes, base)
    dnew = cvec % base                                    # newest digit of c'
    dq = tail % base                                      # newest digit of c
    legal_state = np.zeros((A + 1, A + 1), bool)          # [dq, dnew]
    for p in range(A):
        legal_state[pret[p] + 1, p + 1] = True
    legc = np.broadcast_to(legal_state[dq[:, None], dnew[:, None]],
                           candc.shape).copy()
    adjc = np.full((codes, codes), np.inf, np.float32)
    adjc[np.repeat(cvec, base)[legc.reshape(-1)],
         candc.reshape(-1)[legc.reshape(-1)]] = 0.0
    group = (np.arange(base ** (k_syms - 1))[None, :] * base
             + (np.arange(A) + 1)[:, None]).astype(np.int64)
    return candc, legc, adjc, group


def _host_tables(route: str, pret: np.ndarray, start: np.ndarray,
                 k_syms: int, pathlen: int, device) -> dict:
    """The host-built tables of ``route`` as tensors on ``device``."""
    if route == "branch-tables":
        idx, alive = _branch_idx_tables(pret, start, pathlen)
        return {"idx": torch.as_tensor(idx, device=device).long(),
                "alive": torch.as_tensor(alive, device=device)}
    if route == "memoryless-acs":
        A = pret.shape[0]
        adj = np.full((A, A), np.inf, np.float32)
        adj[np.arange(A)[:, None], pret] = 0.0
        tabs = {"candc": pret.astype(np.int64),
                "legc": np.ones(pret.shape, bool), "adj": adj}
    elif route == "path-acs":
        candc, legc, adjc, group = _window_transitions(pret, k_syms)
        tabs = {"candc": candc, "legc": legc, "adj": adjc, "group": group}
    else:
        return {}
    return {k: torch.as_tensor(v, device=device) for k, v in tabs.items()}


def _pulse_span(pulses: torch.Tensor, w: int, up: int, lead: int,
                nsamps: int) -> torch.Tensor:
    """span[i, j, t] = pulses[i, (w - 1 - lead - j)*up + t] where that index
    lies in the pulse, else 0: the samples t of the model that symbol j of
    a w-symbol window contributes through pulse i, for a span that starts
    ``lead`` symbols before the window's last symbol (the JAX package's
    full convolution of the upsampled window, sliced at (w-1-lead)*up)."""
    L, pulselen = pulses.shape
    j = torch.arange(w, device=pulses.device)[:, None]
    t = torch.arange(nsamps, device=pulses.device)[None, :]
    k = (w - 1 - lead - j) * up + t                       # (w, nsamps)
    inside = (k >= 0) & (k < pulselen)
    span = pulses[:, k.clamp(0, pulselen - 1)]            # (L, w, nsamps)
    return torch.where(inside, span, 0)


def _phases(omegas: torch.Tensor, n: int, up: int, nt: int) -> torch.Tensor:
    """(n, L, nt) exp(-1j * omega_i * (m*up + t)) for m < n, t < nt; the
    argument formed in float32, as the JAX package forms it."""
    dev = omegas.device
    m = torch.arange(n, dtype=torch.float32, device=dev)
    t = torch.arange(nt, dtype=torch.float32, device=dev)
    arg = omegas[None, :, None] * (m[:, None, None] * up + t[None, None, :])
    return torch.polar(torch.ones_like(arg), -arg)


def _padded(ys: torch.Tensor, length: int) -> torch.Tensor:
    """ys zero-padded on the right to at least ``length`` samples."""
    return torch.nn.functional.pad(ys, (0, max(0, length - ys.shape[-1])))


def _obs_windows(ys: torch.Tensor, pathlen: int, up: int, nt: int):
    """((B, pathlen, nt) samples ys[..., n*up + t] (zero past the end),
    (pathlen, nt) validity n*up + t < len(y))."""
    idx = (torch.arange(pathlen, device=ys.device)[:, None] * up
           + torch.arange(nt, device=ys.device)[None, :])
    return _padded(ys, pathlen * up + nt)[:, idx], idx < ys.shape[-1]


# ---------------------------------------------------------------------------
# Branch-metric tables
# ---------------------------------------------------------------------------

def _memoryless_tables(ys, alphabet, pulses, omegas, *, up, pathlen):
    """(B, pathlen, A) branch metrics of a memoryless trellis (pulselen ==
    up, so the full and short metrics coincide):

        s[n, p, t] = alphabet[p] * sum_i pulse_i[t] e^{-j omega_i (n up+t)}
        bm[n, p]   = || valid(y[n up + t]) - s[n, p, t] ||^2
    """
    base = (pulses[None, :, :up] * _phases(omegas, pathlen, up, up)).sum(1)
    s = alphabet[None, :, None] * base[:, None, :]          # (N, A, up)
    ywin, valid = _obs_windows(ys, pathlen, up, up)
    d = torch.where(valid[None, :, None, :], ywin[:, :, None, :] - s[None], 0)
    return (d.real * d.real + d.imag * d.imag).sum(-1)


def _code_branch_tables(ys, alphabet, pulses, omegas, *, up, pulselen,
                        k_syms, pathlen):
    """(bm_full, bm_short), each (B, pathlen, codes), over the window codes
    of :func:`_window_transitions`: per-code pulse synthesis and per-step
    source phases in one vectorized pass."""
    A = alphabet.shape[0]
    base = A + 1
    codes = base ** k_syms
    digits = (np.arange(codes)[:, None]
              // base ** np.arange(k_syms - 1, -1, -1)[None, :]) % base
    valtable = torch.cat([torch.zeros(1, dtype=alphabet.dtype,
                                      device=alphabet.device), alphabet])
    win = valtable[torch.as_tensor(digits, device=alphabet.device)]
    # s0[c, i, t] = sum_j win[c, j] * pulses[i, (k-1-j)*up + t]
    span = _pulse_span(pulses, k_syms, up, 0, pulselen)     # (L, k, P)
    s0 = (win[:, None, :, None] * span[None]).sum(2)        # (codes, L, P)
    S = (s0[None] * _phases(omegas, pathlen, up, pulselen)[:, None]).sum(2)
    ywin, valid = _obs_windows(ys, pathlen, up, pulselen)
    d = torch.where(valid[None, :, None, :], ywin[:, :, None, :] - S[None], 0)
    dsq = d.real * d.real + d.imag * d.imag                 # (B, N, C, P)
    return dsq.sum(-1), dsq[..., :up].sum(-1)


# ---------------------------------------------------------------------------
# Min-plus chain
# ---------------------------------------------------------------------------

def _minplus_chain_batched(mats, m0, candc, legc):
    """Batched min-plus Viterbi chain.

    mats: (B, N-1, S, S) step matrices (branch metric + inf-masked
    adjacency: mats[b, l, p, j] is the cost of j at symbol l -> p at l+1),
    m0: (B, S) initial metrics, candc/legc: (S, U) predecessor candidate
    codes and their legality. Returns (metrics (B, S), codeseq (B, N, S)):
    codeseq[b, n, s] is the state at symbol n of the best path ending in
    s. N == 1 gives (m0, the identity map).

    Three phases, as the JAX package's: each block of _KBL steps reduces
    to one transfer matrix by a pairwise tree, a short scan chains the
    block matrices, then every block replays its steps from its start
    metrics at once. Backpointers compose the same way in reverse.
    """
    B, L, S, _ = mats.shape
    dev = mats.device
    idmap = torch.arange(S, device=dev).expand(B, S)
    if L == 0:
        return m0, idmap[:, None, :]
    nb = -(-L // _KBL)
    pad = nb * _KBL - L
    if pad:
        ident = torch.full((S, S), _INF, device=dev).fill_diagonal_(0.0)
        mats = torch.cat([mats, ident.expand(B, pad, S, S)], dim=1)
    matsp = mats.reshape(B, nb, _KBL, S, S)

    cur = matsp
    while cur.shape[2] > 1:
        a, b = cur[:, :, 0::2], cur[:, :, 1::2]
        # "later after earlier": C[p, j] = min_k b[p, k] + a[k, j]
        cur = (b[..., :, :, None] + a[..., None, :, :]).amin(dim=-2)
    blockmats = cur[:, :, 0]                                # (B, NB, S, S)

    m, starts = m0, []
    for i in range(nb):
        starts.append(m)                                    # exclusive
        m = (blockmats[:, i] + m[:, None, :]).amin(dim=-1)
    m, steps = torch.stack(starts, dim=1), []               # (B, NB, S)
    for k in range(_KBL):
        m = (matsp[:, :, k] + m[..., None, :]).amin(dim=-1)
        steps.append(m)
    all_m = torch.stack(steps, dim=2).reshape(B, nb * _KBL, S)[:, :L]
    m_prev = torch.cat([m0[:, None], all_m[:, :-1]], dim=1)  # (B, L, S)

    cand = torch.where(legc, m_prev[:, :, candc], _INF)     # (B, L, S, U)
    best_u = cand.argmin(dim=-1)                            # (B, L, S)
    bq = torch.gather(candc.expand(B, L, -1, -1), 3, best_u[..., None])[..., 0]

    # F_l = bq[l] maps the state at symbol l+1 to symbol l; the suffix
    # composition (F_m o ... o F_{L-1})(end) is the state at symbol m
    if pad:
        bq = torch.cat([bq, idmap[:, None].expand(B, pad, S)], dim=1)
    bqp = bq.reshape(B, nb, _KBL, S)
    cur = bqp
    while cur.shape[2] > 1:
        # earlier o later
        cur = torch.gather(cur[:, :, 0::2], -1, cur[:, :, 1::2])
    blockmaps = cur[:, :, 0]                                # (B, NB, S)
    tail, tails = idmap, [None] * nb
    for i in reversed(range(nb)):
        tails[i] = tail
        tail = torch.gather(blockmaps[:, i], -1, tail)
    c, suffix = torch.stack(tails, dim=1), [None] * _KBL
    for k in reversed(range(_KBL)):
        c = torch.gather(bqp[:, :, k], -1, c)
        suffix[k] = c
    suffix = torch.stack(suffix, dim=2).reshape(B, nb * _KBL, S)[:, :L]
    return all_m[:, -1], torch.cat([suffix, idmap[:, None]], dim=1)


def _path_acs(ys, alphabet, pulses, omegas, start_mask, tables, *, up,
              pulselen, k_syms, pathlen):
    """Path-metric Viterbi of a burst batch on the min-plus chain: the
    A-state trellis for k_syms == 1, exact MLSE over the window-code trellis
    otherwise. Returns (paths (B, A, pathlen) int32, metrics (B, A))."""
    B = ys.shape[0]
    A = alphabet.shape[0]
    if k_syms == 1:
        bm = _memoryless_tables(ys, alphabet, pulses, omegas, up=up,
                                pathlen=pathlen)            # (B, N, A)
        m0 = torch.where(start_mask, bm[:, 0], _INF)
    else:
        _, bm = _code_branch_tables(ys, alphabet, pulses, omegas, up=up,
                                    pulselen=pulselen, k_syms=k_syms,
                                    pathlen=pathlen)        # (B, N, C)
        # window = silence + first symbol -> code p + 1
        m0 = torch.full_like(bm[:, 0], _INF)
        m0[:, 1: A + 1] = torch.where(start_mask, bm[:, 0, 1: A + 1], _INF)
    mats = bm[:, 1:, :, None] + tables["adj"]
    metrics, codeseq = _minplus_chain_batched(mats, m0, tables["candc"],
                                              tables["legc"])
    if k_syms == 1:
        return codeseq.transpose(1, 2).to(torch.int32), metrics
    # per final alphabet state, the best window code ending in it
    group = tables["group"]                                 # (A, G)
    mg = metrics[:, group]                                  # (B, A, G)
    j = mg.argmin(dim=-1)                                   # (B, A)
    cstar = group[torch.arange(A, device=group.device), j]  # (B, A)
    stateseq = torch.remainder(codeseq, A + 1) - 1          # (B, N, C)
    paths = torch.gather(stateseq, 2, cstar[:, None, :].expand(
        B, pathlen, A))                                     # (B, N, A)
    return (paths.transpose(1, 2).to(torch.int32),
            torch.gather(mg, 2, j[..., None])[..., 0])


def viterbi_path_acs_batch(ys, alphabet, pretransitions, pulses, omegas,
                           start_mask, *, up, pulselen, k_syms, pathlen,
                           survivor_metric="path", pret_static,
                           start_static):
    """Batched path-metric Viterbi over a (B, nsamps) burst matrix on the
    min-plus chain (the throughput surface for burst batches, the
    reference's block-per-burst GPU pattern).

    Per burst, the semantics of ``_viterbi_run`` with
    survivor_metric='path' (k_syms == 1: the A-state memoryless trellis;
    k_syms > 1: MLSE over the (A+1)^k window-state trellis), without its
    size gate. The trellis arguments are tensors or arrays; they go to
    ``ys``'s device. Returns (paths (B, A, pathlen) int32, metrics (B, A)).
    """
    if survivor_metric != "path":
        raise ValueError("batched ACS implements survivor_metric='path'")
    dev = ys.device
    route = "memoryless-acs" if k_syms == 1 else "path-acs"
    tables = _host_tables(route, np.asarray(pret_static, np.int64),
                          np.asarray(start_static, bool), k_syms, pathlen,
                          dev)
    del pretransitions      # the trellis is pret_static, as in the JAX package
    return _path_acs(
        ys.to(torch.complex64), to_tensor(alphabet, dev).to(torch.complex64),
        to_tensor(pulses, dev).to(torch.complex64),
        to_tensor(omegas, dev).to(torch.float32),
        to_tensor(start_mask, dev).bool(), tables, up=up, pulselen=pulselen,
        k_syms=k_syms, pathlen=pathlen)


# ---------------------------------------------------------------------------
# Sequential scans
# ---------------------------------------------------------------------------

def _scan_start(alphabet, start_mask, w: int, y0, model0, up: int):
    """The sequential trellis before its first step: each allowed state a
    starts a window of silence ending in alphabet[a] (w symbols), its metric
    the short branch metric of ``model0(windows)`` against ``y0``; other
    states start dead (infinite metric, zero window). Returns (metrics,
    windows)."""
    A = alphabet.shape[0]
    init = torch.zeros((A, w), dtype=alphabet.dtype, device=alphabet.device)
    init[:, -1] = alphabet
    e0 = torch.abs(y0[:up] - model0(init)[:, :up]) ** 2
    metrics = torch.where(start_mask, e0.sum(-1), _INF)
    return metrics, torch.where(start_mask[:, None], init, 0)


def _initial_paths(A: int, pathlen: int, device) -> torch.Tensor:
    """(A, pathlen) survivor paths before the first step: state a at symbol
    0, zeros after (a step that decides no symbol leaves its zero)."""
    paths = torch.zeros((A, pathlen), dtype=torch.int64, device=device)
    paths[:, 0] = torch.arange(A, device=device)
    return paths


def _scan_step(n, metrics, windows, paths, pret, alphabet, model, yseg,
               valid, up: int, path_metric: bool):
    """One symbol of the sequential trellis, vectorized over (state,
    transition): each state p extends each allowed predecessor's window by
    alphabet[p], ``model`` synthesizes those (A, T, w) windows' samples,
    and the survivor is the argmin of the branch metric (plus the path
    metric when ``path_metric``), ties to the first transition.
    Predecessors with infinite metrics are masked (reference
    calcAllBranchMetrics). Returns (metrics, windows, paths)."""
    A, T = pret.shape
    a_idx = torch.arange(A, device=pret.device)
    newest = alphabet[:, None, None].expand(A, T, 1)
    w = torch.cat([windows[pret, 1:], newest], dim=-1)
    e = torch.abs(torch.where(valid, yseg - model(w), 0)) ** 2
    pre_inf = torch.isinf(metrics)[pret]
    full = torch.where(pre_inf, _INF, e.sum(-1))
    short = torch.where(pre_inf, _INF, e[..., :up].sum(-1))
    best_t = (metrics[pret] + full if path_metric else full).argmin(dim=1)
    best_q = pret[a_idx, best_t]
    metrics = torch.where(torch.isinf(full).all(dim=1), _INF,
                          metrics[best_q] + short[a_idx, best_t])
    paths = paths[best_q]
    paths[:, n] = a_idx
    windows = torch.cat([windows[best_q, 1:], alphabet[:, None]], dim=1)
    return metrics, windows, paths


def _synth(w, span, phase):
    """Model samples of windows w (..., W): each source's pulse span (L, W,
    P) summed over the window's symbols, times its phase (L, P), summed
    over the sources."""
    return ((w[..., None, :, None] * span).sum(-2) * phase).sum(-2)


def _viterbi_run_scan(y, alphabet, pretransitions, pulses, omegas,
                      start_mask, *, up, pulselen, k_syms, pathlen,
                      survivor_metric: str = "branch"):
    """The general trellis: one step per symbol, each vectorized over
    (state, transition); survivors carry their last k_syms symbols.
    Returns (paths (A, pathlen) int32, metrics (A,))."""
    pret = pretransitions.long()
    span = _pulse_span(pulses, k_syms, up, 0, pulselen)     # (L, k, P)
    phase = _phases(omegas, pathlen, up, pulselen)          # (N, L, P)
    ywin, valid = _obs_windows(y[None], pathlen, up, pulselen)
    ywin = ywin[0]
    metrics, windows = _scan_start(alphabet, start_mask, k_syms, ywin[0],
                                   lambda w: _synth(w, span, phase[0]), up)
    paths = _initial_paths(pret.shape[0], pathlen, y.device)
    for n in range(1, pathlen):
        metrics, windows, paths = _scan_step(
            n, metrics, windows, paths, pret, alphabet,
            lambda w: _synth(w, span, phase[n]), ywin[n], valid[n], up,
            survivor_metric == "path")
    return paths.to(torch.int32), metrics


def _viterbi_run(y, alphabet, pretransitions, pulses, omegas, start_mask, *,
                 up, pulselen, k_syms, pathlen, survivor_metric="branch",
                 pret_static=None, start_static=None, tables=None):
    """Dispatcher (see the module docstring), with the JAX package's gate.
    ``pret_static``/``start_static`` (arrays or nested tuples) say the
    trellis is known on the host; ``tables`` are its host tables for this
    route and ``pathlen`` when the caller keeps them. Returns (paths (A,
    pathlen) int32, metrics (A,))."""
    A = alphabet.shape[0]
    static = pret_static is not None and start_static is not None
    route = _viterbi_route(A, k_syms, pathlen, survivor_metric, static)
    if route == "scan":
        return _viterbi_run_scan(
            y, alphabet, pretransitions, pulses, omegas, start_mask, up=up,
            pulselen=pulselen, k_syms=k_syms, pathlen=pathlen,
            survivor_metric=survivor_metric)
    if tables is None:
        tables = _host_tables(route, np.asarray(pret_static, np.int64),
                              np.asarray(start_static, bool), k_syms,
                              pathlen, y.device)
    if route == "branch-tables":
        bm = _memoryless_tables(y[None], alphabet, pulses, omegas, up=up,
                                pathlen=pathlen)[0]         # (N, A)
        metrics = torch.where(tables["alive"],
                              torch.gather(bm, 1, tables["idx"]).sum(0), _INF)
        return tables["idx"].T.to(torch.int32), metrics
    paths, metrics = _path_acs(y[None], alphabet, pulses, omegas, start_mask,
                               tables, up=up, pulselen=pulselen,
                               k_syms=k_syms, pathlen=pathlen)
    return paths[0], metrics[0]


# ---------------------------------------------------------------------------
# Demodulator classes
# ---------------------------------------------------------------------------

class ViterbiDemodulator:
    """Trellis demodulator (reference ViterbiDemodulator).

    Parameters (the JAX package's, in its order, plus ``device``)
    ----------
    alphabet : (A,) complex — constellation symbol values.
    pretransitions : (A, T) int — allowed predecessor states per state.
    pulses : (L, pulselen) complex — per-source pulse shapes (constant
        amplitude/phase embedded).
    omegas : (L,) float — per-source angular frequency offsets (rad/sample).
    up : int — samples per symbol.
    allowed_start_idx : int array — states allowed at symbol 0.
    survivor_metric : "branch" (the reference's survivor selection by
        branch metric) or "path" (textbook ACS).
    device : where the trellis tables live (``cuda`` when None); inputs
        must be there too.

    The numpy constants stay as attributes (the JAX names); host tables
    are built once per ``pathlen`` and kept.
    """

    def __init__(self, alphabet, pretransitions, pulses, omegas, up: int,
                 allowed_start_idx=np.array([0]),
                 survivor_metric: str = "branch", device=None):
        if survivor_metric not in ("branch", "path"):
            raise ValueError("survivor_metric must be 'branch' (reference "
                             "semantics) or 'path' (textbook ACS)")
        self.survivor_metric = survivor_metric
        self.alphabet = np.asarray(alphabet, dtype=np.complex64)
        self.pretransitions = np.asarray(pretransitions, dtype=np.int32)
        if self.alphabet.shape[0] != self.pretransitions.shape[0]:
            raise ValueError("Number of transitions is inconsistent.")
        self.pulses = np.asarray(pulses, dtype=np.complex64)
        self.omegas = np.asarray(omegas, dtype=np.float32)
        self.up = int(up)
        if self.omegas.shape[0] != self.pulses.shape[0]:
            raise ValueError("Number of sources is inconsistent.")
        self.pulselen = int(self.pulses.shape[1])
        if self.pulselen % self.up != 0:
            raise ValueError("pulse length must be a multiple of up")
        self.pulse_len_in_syms = self.pulselen // self.up
        self.allowed_start_idx = np.asarray(allowed_start_idx)
        self.device = resolve_device(device)
        self._start = np.zeros(self.alphabet.shape[0], dtype=bool)
        self._start[self.allowed_start_idx] = True
        self._t = {name: torch.as_tensor(getattr(self, name),
                                         device=self.device)
                   for name in ("alphabet", "pretransitions", "pulses",
                                "omegas")}
        self._t["start"] = torch.as_tensor(self._start, device=self.device)
        self._tables: dict[int, dict] = {}

    @classmethod
    def from_numpy_params(cls, params: dict, device=None):
        """Build the port's demodulator from a JAX instance's attributes:
        ``alphabet``, ``pretransitions``, ``pulses``, ``omegas``, ``up``,
        ``allowed_start_idx``, ``survivor_metric``."""
        return cls(params["alphabet"], params["pretransitions"],
                   params["pulses"], params["omegas"], params["up"],
                   params["allowed_start_idx"],
                   params.get("survivor_metric", "branch"), device=device)

    def _check(self, y: torch.Tensor) -> torch.Tensor:
        if y.device != self.device:
            raise ValueError(f"y on {y.device}, demodulator on {self.device}")
        return y.to(torch.complex64)

    def run(self, y: torch.Tensor, pathlen: int):
        """Demodulate ``pathlen`` symbols from ``y``. Returns (best path
        symbol values, final path metrics, all survivor paths)."""
        y, pathlen, t = self._check(y), int(pathlen), self._t
        tables = self._tables.get(pathlen)
        if tables is None:
            route = _viterbi_route(self.alphabet.shape[0],
                                   self.pulse_len_in_syms, pathlen,
                                   self.survivor_metric, True)
            tables = self._tables.setdefault(pathlen, _host_tables(
                route, self.pretransitions.astype(np.int64), self._start,
                self.pulse_len_in_syms, pathlen, self.device))
        paths, metrics = _viterbi_run(
            y, t["alphabet"], t["pretransitions"], t["pulses"], t["omegas"],
            t["start"], up=self.up, pulselen=self.pulselen,
            k_syms=self.pulse_len_in_syms, pathlen=pathlen,
            survivor_metric=self.survivor_metric,
            pret_static=self.pretransitions, start_static=self._start,
            tables=tables)
        vals = t["alphabet"][paths.long()]
        return vals[torch.argmin(metrics)], metrics, vals


class BurstyViterbiDemodulator(ViterbiDemodulator):
    """Trellis demod of periodic bursts with guard gaps (reference
    BurstyViterbiDemodulator).

    Symbols are laid out as repeating periods of ``num_burst_syms`` active
    symbols followed by ``num_guard_syms`` silent ones. During guard periods
    all survivor paths freeze; at each new burst every surviving end-state is
    fully connected to the allowed start states, with the branch metric
    spanning the guard gap. Survivor windows carry ``pulselen/up +
    num_guard_syms`` symbols so the new-burst step can synthesize across the
    gap. Which of the normal / new-burst / guard steps runs depends only on
    n mod period, so the host decides it.
    """

    def __init__(self, alphabet, pretransitions, pulses, omegas, up: int,
                 num_burst_syms: int, num_guard_syms: int,
                 allowed_start_idx=None, device=None):
        if allowed_start_idx is None:
            allowed_start_idx = np.arange(len(alphabet))
        super().__init__(alphabet, pretransitions, pulses, omegas, up,
                         allowed_start_idx, device=device)
        self.num_burst_syms = int(num_burst_syms)
        self.num_guard_syms = int(num_guard_syms)
        self.num_period_syms = self.num_burst_syms + self.num_guard_syms

    @classmethod
    def from_numpy_params(cls, params: dict, device=None):
        """Build the port's demodulator from a JAX instance's attributes:
        those of ``ViterbiDemodulator.from_numpy_params`` but
        ``survivor_metric``, and ``num_burst_syms``, ``num_guard_syms``."""
        return cls(params["alphabet"], params["pretransitions"],
                   params["pulses"], params["omegas"], params["up"],
                   params["num_burst_syms"], params["num_guard_syms"],
                   params["allowed_start_idx"], device=device)

    def run(self, y: torch.Tensor, pathlen: int):
        y, pathlen, t = self._check(y), int(pathlen), self._t
        paths, metrics = _bursty_viterbi_run(
            y, t["alphabet"], t["pretransitions"], t["pulses"], t["omegas"],
            t["start"], up=self.up, pulselen=self.pulselen,
            k_syms=self.pulse_len_in_syms, pathlen=pathlen,
            burst=self.num_burst_syms, guard=self.num_guard_syms)
        # guard-period symbols are never decided: they are silent (0), as in
        # the reference where paths[n] stays 0 through guard periods
        active = (torch.arange(pathlen, device=y.device)
                  % self.num_period_syms) < self.num_burst_syms
        symvals = torch.where(active[None, :], t["alphabet"][paths.long()], 0)
        return symvals[torch.argmin(metrics)], metrics, symvals


def _bursty_viterbi_run(y, alphabet, pretransitions, pulses, omegas,
                        start_mask, *, up, pulselen, k_syms, pathlen, burst,
                        guard):
    """The bursty trellis scan. Returns (paths (A, pathlen) int32, metrics
    (A,))."""
    A = alphabet.shape[0]
    a_idx = torch.arange(A, device=y.device)
    pret = pretransitions.long()
    period = burst + guard
    W = k_syms + guard                    # carry window length in symbols
    extlen = guard * up + pulselen
    span = _pulse_span(pulses, W, up, 0, pulselen)          # (L, W, P)
    span_ext = _pulse_span(pulses, W, up, guard, extlen)    # (L, W, E)
    phase = _phases(omegas, pathlen, up, pulselen)          # (N, L, P)
    phase_ext = _phases(omegas, pathlen, up, extlen)        # (N, L, E)
    ywin, valid = _obs_windows(y[None], pathlen, up, pulselen)
    yext, valid_ext = _obs_windows(y[None], pathlen, up, extlen)
    ywin, yext = ywin[0], yext[0]

    def shifted_in_zero(windows):
        return torch.cat([windows[:, 1:], torch.zeros_like(windows[:, :1])],
                         dim=1)

    metrics, windows = _scan_start(alphabet, start_mask, W, ywin[0],
                                   lambda w: _synth(w, span, phase[0]), up)
    paths = _initial_paths(A, pathlen, y.device)
    newest = alphabet[:, None, None].expand(A, A, 1)
    for n in range(1, pathlen):
        if n % period >= burst:           # guard: freeze, slide in silence
            windows = shifted_in_zero(windows)
        elif n % period:                  # normal step, branch survivors
            metrics, windows, paths = _scan_step(
                n, metrics, windows, paths, pret, alphabet,
                lambda w: _synth(w, span, phase[n]), ywin[n], valid[n], up,
                False)
        else:                             # new burst: any end -> any start
            m = n - guard
            w = torch.cat([windows[None, :, 1:].expand(A, A, W - 1),
                           newest], dim=-1)                 # (A_p, A_q, W)
            d = torch.where(valid_ext[m],
                            yext[m] - _synth(w, span_ext, phase_ext[m]), 0)
            e = torch.abs(d) ** 2
            dead = torch.isinf(metrics)[None, :] | ~start_mask[:, None]
            full = torch.where(dead, _INF, e.sum(-1))
            short = torch.where(dead, _INF, e[..., : guard * up + up].sum(-1))
            best_q = full.argmin(dim=1)
            all_inf = torch.isinf(full).all(dim=1)
            metrics = torch.where(all_inf, _INF,
                                  metrics[best_q] + short[a_idx, best_q])
            new_paths = paths[best_q]
            new_paths[:, n] = a_idx
            paths = torch.where(all_inf[:, None], paths, new_paths)
            windows = torch.where(
                all_inf[:, None], shifted_in_zero(windows),
                torch.cat([windows[best_q, 1:], alphabet[:, None]], dim=1))
    return paths.to(torch.int32), metrics

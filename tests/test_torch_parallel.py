"""The port's distribution layer (``pydsproutines_tpu_torch.parallel``)
against the JAX package's (``pydsproutines_tpu.parallel``) and against the
single-device calls of both.

The JAX side runs in this process on its 8 virtual CPU devices
(``tests/conftest.py``). The port runs in one spawned 4-rank gloo group
for the whole module (``tests/torch_parallel_ranks.py``): each rank runs
every case on a (4,) "dsp" mesh and on one axis of a (2, 2) ("time",
"shifts") mesh, and the parent compares what each rank saw. Inputs are made
here from one numpy seed and handed to both sides. Tolerances are the JAX
tests' (``tests/test_parallel.py``); the port against its own
single-device call is held exact where its arithmetic per output does not
depend on the block it lies in (everything but the FIR, whose plain twin's
product over a halo'd block is rounded differently: 1e-6 of the signal's
scale).

The checks that need no second rank (the ValueErrors, the mesh's device
rules, the world-1 path) run in this process: on a single-rank group, or
on torch's in-process "fake" group of world 4 where a check needs four
ranks to fail (nothing crosses ranks before it).
"""

from __future__ import annotations

import concurrent.futures
import pickle
import tempfile
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal as sps
import torch
import torch.distributed as dist

from pydsproutines_tpu import parallel as jpar
from pydsproutines_tpu.ops import fast_xcorr, lfilter_fir, wola
from pydsproutines_tpu.ops.groupxcorr import GroupXcorrCZT, GroupXcorrFFT
from pydsproutines_tpu_torch import parallel as tpar
from pydsproutines_tpu_torch.ops import fast_xcorr as t_fast_xcorr
from pydsproutines_tpu_torch.ops import groupxcorr as tg
from pydsproutines_tpu_torch.ops import lfilter_fir as t_lfilter
from pydsproutines_tpu_torch.ops import wola as t_wola
from pydsproutines_tpu_torch.parallel import dryrun

import torch_parallel_ranks

WORLD = 4
SEED = 20261017


def _crandn(rng, shape):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _firwin(taps, cutoff):
    return sps.firwin(taps, cutoff).astype(np.float32)


def _cases():
    """name -> (kind, numpy inputs), the shapes of tests/test_parallel.py."""
    rng = np.random.default_rng(SEED)
    # a QPSK burst of 256 at 777 in 2048 samples of noise, 10 dB, 0.021 fs
    syms = np.exp(0.5j * np.pi * rng.integers(0, 4, 256)).astype(np.complex64)
    rx = (_crandn(rng, 2048) / np.sqrt(2)).astype(np.complex64)
    rx[777:777 + 256] += (np.sqrt(10.0) * syms
                          * np.exp(2j * np.pi * 0.021 * np.arange(256)))
    cases = {
        "fast_xcorr": ("xcorr", dict(cutout=syms, rx=rx,
                                     shifts=np.arange(640, 920))),
        "caf_peak": ("caf_peak", dict(cutout=syms, rx=rx,
                                      shifts=np.arange(640, 896))),
        "lfilter": ("lfilter", dict(taps=_firwin(63, 0.2),
                                    x=_crandn(rng, 4096))),
        "wola_n_eq_dec": ("wola", dict(f_tap=_firwin(64, 1 / 8),
                                       x=_crandn(rng, 4096), dec=8, n=8)),
        "wola_n_eq_2dec": ("wola", dict(f_tap=_firwin(32, 1 / 4),
                                        x=_crandn(rng, 2048), dec=4, n=8)),
        "wola_time_axis": ("wola", dict(f_tap=_firwin(16, 1 / 4),
                                        x=_crandn(rng, 1024), dec=4, n=4)),
        # 81*N taps (jump = 162 rows) at N == 2*Dec, 163 rows a rank of 4:
        # odd, so block edges land on both row parities
        "wola_odd_rows": ("wola", dict(f_tap=_firwin(81 * 16, 1 / 8),
                                       x=_crandn(rng, WORLD * 8 * 163),
                                       dec=8, n=16)),
        "multichannel_wola": ("mc_wola", dict(f_tap=_firwin(64, 1 / 8),
                                              x=_crandn(rng, (16, 1024)),
                                              dec=8, n=8)),
    }
    fs, glen, m = 1e5, 128, 4
    starts = np.arange(m) * 512
    span = int(starts[-1] + glen)
    y = _crandn(rng, span)
    rx_g = (0.05 * _crandn(rng, span + 300)).astype(np.complex64)
    rx_g[123: 123 + span] += y                         # true shift 123
    bw = fs / glen / 2
    jx = GroupXcorrCZT(y, starts, np.full(m, glen), -8 * bw, 7 * bw, bw, fs)
    params = {"ystack": jx.ystack, "starts": jx.starts,
              "lengths": jx.lengths, "group_phases": jx.group_phases,
              "ystack_norm_sq": jx.ystack_norm_sq, "tones": jx.plan.tones,
              "f1": jx.plan.f1, "bin_width": jx.plan.bin_width,
              "k": jx.plan.k, "fs": jx.plan.fs}
    cases["group_czt"] = ("group_czt", dict(params=params, rx=rx_g,
                                            shifts=np.arange(64, 64 + 128)))
    starts_f = np.arange(3) * 256
    cases["group_fft"] = ("group_fft", dict(
        ygroups=_crandn(rng, (3, 64)), starts=starts_f, fs=fs,
        rx=_crandn(rng, 1500), shifts=np.arange(32, 32 + 64)))
    return cases, jx


def _jax_refs(cases, jx):
    """name -> (JAX sharded outputs, JAX single-device outputs)."""
    mesh8 = jpar.make_mesh((8,), ("dsp",))
    refs = {}
    for name, (kind, inp) in cases.items():
        a = {k: jnp.asarray(v) for k, v in inp.items()
             if isinstance(v, np.ndarray)}
        if kind == "xcorr":
            q, b = jpar.sharded_fast_xcorr(a["cutout"], a["rx"], a["shifts"],
                                           mesh8)
            qs, bs = fast_xcorr(a["cutout"], a["rx"], freqsearch=True,
                                shifts=a["shifts"])
            refs[name] = {"qf2": q, "bins": b}, {"qf2": qs, "bins": bs}
        elif kind == "caf_peak":
            pk = jpar.sharded_caf_peak(a["cutout"], a["rx"], a["shifts"],
                                       mesh8)
            qs, bs = fast_xcorr(a["cutout"], a["rx"], freqsearch=True,
                                shifts=a["shifts"])
            i = int(np.argmax(np.asarray(qs)))
            refs[name] = ({"peak": pk}, {"peak": (
                qs[i], inp["shifts"][i], bs[i])})
        elif kind == "lfilter":
            refs[name] = ({"y": jpar.sharded_lfilter(a["taps"], a["x"],
                                                     mesh8)},
                          {"y": lfilter_fir(a["taps"], a["x"])})
        elif kind in ("wola", "mc_wola"):
            mesh, axis = mesh8, "dsp"
            if name == "wola_time_axis":
                mesh, axis = jpar.make_mesh((2, 4), ("time", "shifts")), \
                    "time"
            elif name == "wola_odd_rows":
                mesh = jpar.make_mesh((WORLD,), ("dsp",))
            fn = (jpar.sharded_wola if kind == "wola"
                  else jpar.sharded_multichannel_wola)
            ch = fn(a["f_tap"], a["x"], inp["dec"], inp["n"], mesh, axis)
            rows = a["x"] if kind == "mc_wola" else a["x"][None]
            single = np.stack([np.asarray(wola(a["f_tap"], r, inp["dec"],
                                               inp["n"])) for r in rows])
            refs[name] = {"ch": ch}, {"ch": single if kind == "mc_wola"
                                      else single[0]}
        elif kind == "group_czt":
            caf, _ = jpar.sharded_group_xcorr_czt(jx, a["rx"], a["shifts"],
                                                  mesh8)
            pk = jpar.sharded_group_xcorr_peak(jx, a["rx"], a["shifts"],
                                               mesh8)
            refs[name] = ({"caf": caf, "peak": pk},
                          {"caf": jx.xcorr(a["rx"], a["shifts"])[0]})
        else:
            gx = GroupXcorrFFT(inp["ygroups"], inp["starts"], inp["fs"])
            refs[name] = ({"caf": jpar.sharded_group_xcorr_fft(
                gx, a["rx"], a["shifts"], mesh8)},
                {"caf": gx.xcorr(a["rx"], a["shifts"])})
    as_np = (lambda v: tuple(np.asarray(e) for e in v)
             if isinstance(v, tuple) else np.asarray(v))
    return {name: tuple({k: as_np(v) for k, v in side.items()}
                        for side in pair) for name, pair in refs.items()}


@pytest.fixture(scope="module")
def run():
    """The cases, the JAX references and what each port rank saw."""
    cases, jx = _cases()
    with tempfile.TemporaryDirectory() as out, \
            concurrent.futures.ThreadPoolExecutor(1) as pool:
        (Path(out) / "cases.pkl").write_bytes(pickle.dumps(cases))
        # the ranks start (~10 s of imports) while JAX computes here
        ranks = pool.submit(dryrun.run_ranks, torch_parallel_ranks.run_cases,
                            WORLD, (out,), "gloo", 240.0)
        refs = _jax_refs(cases, jx)
        ranks.result()
        seen = [pickle.loads((Path(out) / f"rank{r}.pkl").read_bytes())
                for r in range(WORLD)]
    return cases, refs, seen


# the JAX tests' tolerances: (rtol, atol) of each output; None is exact
TOL = {"fast_xcorr": {"qf2": (1e-5, 0.0), "bins": None},
       "lfilter": {"y": (0.0, 1e-4)},
       "group_czt": {"caf": (1e-4, 1e-7)},
       "group_fft": {"caf": (1e-4, 1e-7)}}
WOLA_TOL = {"ch": (0.0, 1e-4)}
# the port's sharded output vs its own single-device call: exact but for
# the FIR (see the module docstring)
SELF_TOL = {"lfilter": (0.0, 1e-6)}


def _close(got, ref, tol, what):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, what
    if tol is None:
        np.testing.assert_array_equal(got, ref, err_msg=what)
    else:
        np.testing.assert_allclose(got, ref, rtol=tol[0], atol=tol[1],
                                   err_msg=what)


def _peak_close(got, ref, what):
    """shift and bin exact; the peak within rel 1e-5."""
    assert (int(got[1]), int(got[2])) == (int(ref[1]), int(ref[2])), what
    assert float(got[0]) == pytest.approx(float(ref[0]), rel=1e-5), what


CASE_NAMES = ["fast_xcorr", "caf_peak", "lfilter", "wola_n_eq_dec",
              "wola_n_eq_2dec", "wola_time_axis", "wola_odd_rows",
              "multichannel_wola", "group_czt", "group_fft"]


@pytest.mark.parametrize("mesh_name", ["dsp", "2d"])
@pytest.mark.parametrize("name", CASE_NAMES)
def test_sharded_matches_jax_and_single_device(run, name, mesh_name):
    """Each rank's block against the matching slice of the JAX sharded
    output, the gathered whole against the JAX sharded and single-device
    outputs, the port against its own single-device call; peaks exact in
    shift and bin, the same on every rank."""
    cases, refs, seen = run
    jax_sharded, jax_single = refs[name]
    tols = TOL.get(name, WOLA_TOL)
    single = seen[0][name, mesh_name]["single"]
    for r in range(WORLD):
        assert seen[r]["jax_imported"] is False
        got = seen[r][name, mesh_name]
        for key, out in got["outs"].items():
            what = f"{name} {key}, rank {r}, mesh {mesh_name}"
            if isinstance(out, tuple):                 # a peak triple
                assert out == seen[0][name, mesh_name]["outs"][key], what
                _peak_close(out, jax_sharded[key], what)
                if name == "caf_peak":
                    _peak_close(out, jax_single[key], what)
                    assert out == single, what
                continue
            ref = jax_sharded[key]
            n = ref.shape[0] // out["size"]
            c = out["coord"]
            _close(out["local"], ref[c * n: (c + 1) * n], tols[key], what)
            _close(out["full"], ref, tols[key], what)
            _close(out["full"], jax_single[key], tols[key], what)
            mine = (dict(zip(("qf2", "bins"), single))[key]
                    if name == "fast_xcorr" else single)
            _close(out["full"], np.asarray(mine), SELF_TOL.get(name), what)
    if name == "group_czt":
        peak = seen[0][name, mesh_name]["outs"]["peak"]
        caf = jax_single["caf"]
        i, j = np.unravel_index(np.argmax(caf), caf.shape)
        assert peak[1] == cases[name][1]["shifts"][i] == 123
        assert peak[2] == j
    if name in ("fast_xcorr", "caf_peak", "wola_n_eq_dec"):
        path, reason = seen[0][name, mesh_name]["route"]
        assert path == "plain" and "cpu tensor" in reason


# ---------------------------------------------------------------------------
# in-process checks: one rank, or torch's fake group of four
# ---------------------------------------------------------------------------

@pytest.fixture
def world1():
    """A single-rank gloo group, started by make_mesh itself."""
    assert not dist.is_initialized()
    mesh = tpar.make_mesh(device_type="cpu")
    yield mesh
    dist.destroy_process_group()


@pytest.fixture
def fake4():
    """A (4,) "dsp" mesh on torch's in-process fake group of world 4."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    yield tpar.make_mesh((4,), device_type="cpu")
    dist.destroy_process_group()


def _fake_calls():
    x = torch.zeros(4096, dtype=torch.complex64)
    taps = torch.ones(8)
    plan = tg.GroupXcorrFFT(np.ones((2, 16), np.complex64), [0, 32], 1.0,
                            device="cpu")
    return {
        "lfilter_len": (lambda m: tpar.sharded_lfilter(taps, x[:4094], m),
                        "len\\(x\\) must divide evenly"),
        "lfilter_block": (lambda m: tpar.sharded_lfilter(
            torch.ones(2048), x, m), "block must be >= filter length"),
        "wola_len": (lambda m: tpar.sharded_wola(taps, x[:4080], 8, 8, m),
                     "mesh axis \\* dec"),
        "wola_block": (lambda m: tpar.sharded_wola(torch.ones(2048), x, 8, 8,
                                                   m),
                       "block must be >= filter length"),
        "mc_wola_ndim": (lambda m: tpar.sharded_multichannel_wola(
            taps, x, 8, 8, m), "\\(channels, len\\)"),
        "mc_wola_channels": (lambda m: tpar.sharded_multichannel_wola(
            taps, x.reshape(2, 2048), 8, 8, m), "channel count"),
        "xcorr_shifts": (lambda m: tpar.sharded_fast_xcorr(
            x[:64], x, np.arange(6), m), "len\\(shifts\\)"),
        "caf_peak_shifts": (lambda m: tpar.sharded_caf_peak(
            x[:64], x, np.arange(6), m), "len\\(shifts\\)"),
        "xcorr_range": (lambda m: tpar.sharded_caf_peak(
            x[:64], x, np.arange(4040, 4044), m), "exceed rx length"),
        "group_shifts": (lambda m: tpar.sharded_group_xcorr_fft(
            plan, x, np.arange(6), m), "len\\(shifts\\)"),
        "group_peak_shifts": (lambda m: tpar.sharded_group_xcorr_peak(
            plan, x, np.arange(6), m), "len\\(shifts\\)"),
        "mesh_too_big": (lambda m: tpar.make_mesh((8,), device_type="cpu"),
                         "needs 8 devices, have 4"),
        "mesh_too_small": (lambda m: tpar.make_mesh((2,), device_type="cpu"),
                           "every rank must be in the mesh"),
        "device_mismatch": (lambda m: tpar.sharded_lfilter(
            taps, x.to("meta"), m), "the mesh on cpu"),
        "dtensor_placement": (lambda m: tpar.sharded_lfilter(
            taps, torch.distributed.tensor.DTensor.from_local(
                x, m, [torch.distributed.tensor.Replicate()]), m),
            "Shard\\(0\\)"),
    }


@pytest.mark.parametrize("case", sorted(_fake_calls()))
def test_value_errors(fake4, case):
    call, match = _fake_calls()[case]
    with pytest.raises(ValueError, match=match):
        call(fake4)


def test_cuda_mesh_without_cuda_raises(monkeypatch):
    """make_mesh() targets the card; without CUDA it raises and starts no
    group (never a quiet CPU run)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device_type='cpu'"):
        tpar.make_mesh()
    with pytest.raises(RuntimeError, match="device_type='cpu'"):
        tpar.default_mesh()
    assert not dist.is_initialized()


def test_world_one_matches_single_device(world1):
    """At world 1 (make_mesh's own in-memory group) each sharded call is the
    single-device call: rank 0's halo is zeros, its block the whole."""
    rng = np.random.default_rng(SEED)
    x = torch.from_numpy(_crandn(rng, 4096))
    f = torch.from_numpy(_firwin(64, 1 / 8))
    d = tpar.sharded_wola(f, x, 8, 8, world1)
    assert d.to_local().shape == d.full_tensor().shape == (512, 8)
    assert torch.equal(d.full_tensor(), t_wola(f, x, 8, 8))
    assert torch.equal(tpar.sharded_lfilter(f, x, world1).to_local(),
                       t_lfilter(f, x))
    shifts = np.arange(0, 512, 2)
    q, b = tpar.sharded_fast_xcorr(x[100:356], x, shifts, world1)
    qs, bs = t_fast_xcorr(x[100:356], x, True, shifts=shifts)
    assert torch.equal(q.to_local(), qs) and torch.equal(b.to_local(), bs)
    i = int(torch.argmax(qs))
    assert tpar.sharded_caf_peak(x[100:356], x, shifts, world1) == (
        float(qs[i]), 100, int(bs[i]))
    assert tpar.sharded_caf_peak.route[0] == "plain"


# chip_smoke's parallel phase at a small size: its sizes, ``scene_burst``'s
# template and the group cell cut down, every plant inside its sweep and on
# rank 2's block of the (b) and (c) sweeps
SMALL_PHASE = {"NCH": 8, "TAPS": 64, "ROWS": 512, "N_RX": 16,
               "SHIFTS_RX": 8, "FIR_TAPS": 16, "N_FIR": 2048, "N_BIG": 512,
               "SHIFTS_BIG": 128, "PAR_PEAK": (77, 300), "N_4": 4096,
               "PAR_LIST_BIN": 300, "G_LEN": 256, "G_BINS": 16,
               "G_SHIFTS": 128, "G_STAR": 70, "G_BIN": 7, "PAR_CUT": 256,
               "PAR_SHIFTS": 64, "PAR_STAR": 40, "PAR_BIN": 5,
               "PAR_CAP": 8192, "PAR_CAP_S0": 512, "PAR_CAP_STAR": 550}


def test_chip_smoke_parallel_phase_on_cpu(monkeypatch):
    """``chip_smoke.parallel_one_rank`` (a single-rank gloo group here) and
    ``parallel_ranks`` (4 spawned gloo ranks, each holding its block and
    peaks against the single-device calls, then the int16 capture flow)
    run on the CPU at a small size: the phase's control flow, shapes and
    checks without the card."""
    import chip_smoke as cs
    for name, value in SMALL_PHASE.items():
        monkeypatch.setattr(cs, name, value)
    cpu = torch.device("cpu")
    one = cs.parallel_one_rank(cpu, ())
    assert not dist.is_initialized()
    assert one["backend"] == "gloo" and one["world"] == 1
    assert set(one["max_abs_err"]) == {
        "sharded_wola", "sharded_multichannel_wola", "sharded_lfilter",
        "sharded_fast_xcorr", "sharded_caf_peak",
        "sharded_caf_peak (listed)", "sharded_group_xcorr_czt",
        "sharded_group_xcorr_peak"}
    ranks = cs.parallel_ranks(cpu)
    assert [r["rank"] for r in ranks] == [0, 1, 2, 3]
    for r in ranks:
        assert r["transport"] == "gloo"
        assert r["capture"]["peak"][1:] == [550, 0]
        assert r["routes"]["sharded_caf_peak"][0] == "plain"

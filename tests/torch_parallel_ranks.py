"""The rank side of ``tests/test_torch_parallel.py``: every case of the
port's distribution layer, run by each rank of a spawned gloo group on the
CPU (plain twins). Kept apart from the test module because a spawned rank
imports the module of the function it runs, and the test module imports
JAX; this one imports only torch, numpy and the port.

A case is ``(kind, inputs)``: ``kind`` names a port call below, ``inputs``
are numpy arrays made by the test from one seed. Each rank runs every case
on a ``(world,)`` "dsp" mesh and on the matching axis of a
``(2, world/2)`` ("time", "shifts") mesh, and pickles what it saw: each
DTensor's local block, its ``full_tensor()`` and the rank's coordinate on
the axis, each peak triple, and (rank 0) the single-device call.
"""

from __future__ import annotations

import pickle
import sys
from pathlib import Path

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from pydsproutines_tpu_torch import ops
from pydsproutines_tpu_torch.ops.groupxcorr import GroupXcorrCZT, GroupXcorrFFT
from pydsproutines_tpu_torch.parallel import (
    make_mesh, sharded_caf_peak, sharded_fast_xcorr, sharded_group_xcorr_czt,
    sharded_group_xcorr_fft, sharded_group_xcorr_peak, sharded_lfilter,
    sharded_multichannel_wola, sharded_wola)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _xcorr(inp, mesh, axis):
    qf2, bins = sharded_fast_xcorr(_t(inp["cutout"]), _t(inp["rx"]),
                                   inp["shifts"], mesh, axis)
    single = ops.fast_xcorr(_t(inp["cutout"]), _t(inp["rx"]), True,
                            shifts=inp["shifts"])
    return {"qf2": qf2, "bins": bins}, single, \
        {"route": sharded_fast_xcorr.route}


def _caf_peak(inp, mesh, axis):
    peak = sharded_caf_peak(_t(inp["cutout"]), _t(inp["rx"]), inp["shifts"],
                            mesh, axis)
    qf2, bins = ops.fast_xcorr(_t(inp["cutout"]), _t(inp["rx"]), True,
                               shifts=inp["shifts"])
    i = int(torch.argmax(qf2))
    single = (float(qf2[i]), int(inp["shifts"][i]), int(bins[i]))
    return {"peak": peak}, single, {"route": sharded_caf_peak.route}


def _lfilter(inp, mesh, axis):
    y = sharded_lfilter(_t(inp["taps"]), _t(inp["x"]), mesh, axis)
    return {"y": y}, ops.lfilter_fir(_t(inp["taps"]), _t(inp["x"])), {}


def _wola(inp, mesh, axis):
    f, x, dec, n = _t(inp["f_tap"]), _t(inp["x"]), inp["dec"], inp["n"]
    ch = sharded_wola(f, x, dec, n, mesh, axis)
    return {"ch": ch}, ops.wola(f, x, dec, n), {"route": sharded_wola.route}


def _mc_wola(inp, mesh, axis):
    f, x, dec, n = _t(inp["f_tap"]), _t(inp["x"]), inp["dec"], inp["n"]
    ch = sharded_multichannel_wola(f, x, dec, n, mesh, axis)
    return {"ch": ch}, torch.stack([ops.wola(f, r, dec, n) for r in x]), {}


def _group_czt(inp, mesh, axis):
    plan = GroupXcorrCZT.from_numpy_params(inp["params"], device="cpu")
    rx = _t(inp["rx"])
    caf, freqs = sharded_group_xcorr_czt(plan, rx, inp["shifts"], mesh, axis)
    peak = sharded_group_xcorr_peak(plan, rx, inp["shifts"], mesh, axis)
    return {"caf": caf, "peak": peak}, plan.xcorr(rx, inp["shifts"])[0], \
        {"freqs": np.asarray(freqs)}


def _group_fft(inp, mesh, axis):
    plan = GroupXcorrFFT(inp["ygroups"], inp["starts"], inp["fs"],
                         device="cpu")
    rx = _t(inp["rx"])
    caf = sharded_group_xcorr_fft(plan, rx, inp["shifts"], mesh, axis)
    return {"caf": caf}, plan.xcorr(rx, inp["shifts"]), {}


KINDS = {"xcorr": _xcorr, "caf_peak": _caf_peak, "lfilter": _lfilter,
         "wola": _wola, "mc_wola": _mc_wola, "group_czt": _group_czt,
         "group_fft": _group_fft}
# the axis of the 2-D mesh each kind splits: time for the halo ops
TIME_KINDS = {"lfilter", "wola"}


def _seen(out, mesh, axis):
    if isinstance(out, DTensor):
        return {"local": out.to_local().numpy(),
                "full": out.full_tensor().numpy(),
                "coord": mesh[axis].get_local_rank(),
                "size": mesh[axis].size()}
    return out                           # a peak triple


def run_cases(rank, world, outdir):
    """Run every case of ``outdir/cases.pkl`` on both meshes; write
    ``outdir/rank{rank}.pkl``. (The cases go by file: spawn's pipe to a
    rank is drained only as the rank imports, so large arguments would
    start the ranks one after another.)"""
    cases = pickle.loads((Path(outdir) / "cases.pkl").read_bytes())
    meshes = {"dsp": make_mesh((world,), ("dsp",), "cpu"),
              "2d": make_mesh((2, world // 2), ("time", "shifts"), "cpu")}
    seen = {}
    for name, (kind, inp) in cases.items():
        for mname, mesh in meshes.items():
            axis = "dsp" if mname == "dsp" else (
                "time" if kind in TIME_KINDS else "shifts")
            outs, single, extra = KINDS[kind](inp, mesh, axis)
            seen[name, mname] = {
                "outs": {k: _seen(v, mesh, axis) for k, v in outs.items()},
                "single": (single if rank == 0 else None), **extra}
    seen["jax_imported"] = "jax" in sys.modules
    (Path(outdir) / f"rank{rank}.pkl").write_bytes(pickle.dumps(seen))

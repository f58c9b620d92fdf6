"""Parity dry runs of the distribution layer on a spawned process group (the
port's counterpart of ``__graft_entry__.dryrun_multichip`` and
``dryrun_multiprocess``).

``run_ranks(fn, world, args)`` starts ``world`` processes (the ``spawn``
start method), joins them into one process group on a file store in a
fresh temporary directory (collectives time out after 60 s) and calls
``fn(rank, world, *args)`` in each; a rank that fails, or a group still
running at the deadline, raises (the ranks are killed then).

``dryrun_multichip(n)`` runs the JAX dry run's five checks on an n-rank
group, each sharded op against the single-device op on the same rank:
time-sharded WOLA and FIR (halo exchange), the shift-sharded CAF sweep and
peak, channel-sharded WOLA and the shift-sharded group CAF; on a 1-D
``("dsp",)`` mesh, and again on a ``(2, n/2)`` ``("time", "shifts")`` mesh
when n is even and >= 4. ``dryrun_multiprocess()`` runs the 2-rank cluster
check (halos and the peak across a process boundary, the input read
through ``shard_local_blocks``, then the ``multihost_pipeline``
walkthrough on both ranks).

    python -m pydsproutines_tpu_torch.parallel.dryrun 4 cpu
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time
from datetime import timedelta
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from scipy import signal as sps

from pydsproutines_tpu_torch.ops import (GroupXcorrCZT, fast_xcorr,
                                         lfilter_fir, wola)
from pydsproutines_tpu_torch.parallel import multihost_pipeline
from pydsproutines_tpu_torch.parallel import (
    make_mesh, sharded_caf_peak, sharded_fast_xcorr, sharded_group_xcorr_czt,
    sharded_lfilter, sharded_multichannel_wola, sharded_wola)
from pydsproutines_tpu_torch.parallel._exchange import device_of
from pydsproutines_tpu_torch.parallel.mesh import BACKENDS, check_device_type
from pydsproutines_tpu_torch.parallel.multihost import (
    flat_mesh, init_distributed, process_shard_bounds, shard_local_blocks)

COLLECTIVE_TIMEOUT = timedelta(seconds=60)


def _rank_main(rank, fn, world, store, backend, args):
    # the ranks never import JAX: drop the JAX settings a parent may carry
    for key in ("XLA_FLAGS", "JAX_PLATFORMS"):
        os.environ.pop(key, None)
    torch.set_num_threads(1)
    if backend == "nccl":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=f"file://{store}",
                            rank=rank, world_size=world,
                            timeout=COLLECTIVE_TIMEOUT)
    try:
        fn(rank, world, *args)
    finally:
        dist.destroy_process_group()


def run_ranks(fn, world: int, args: tuple = (), backend: str = "gloo",
              timeout: float = 300.0) -> None:
    """Run ``fn(rank, world, *args)`` on ``world`` spawned ranks of one
    ``backend`` process group; ``fn`` must be importable by name (a module
    function). Keep ``args`` small and pass bulk data by file: spawn's pipe
    to a rank drains only as the rank imports, so large arguments start the
    ranks one after another. Raises if a rank raises or exits, or after ``timeout``
    seconds (the ranks are killed)."""
    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.start_processes(
            _rank_main, args=(fn, world, str(Path(tmp) / "store"), backend,
                              args),
            nprocs=world, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=1.0):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{world} ranks still running after "
                                       f"{timeout} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()


def _close(got, ref, atol=1e-4, rtol=0.0, what=""):
    got, ref = got.cpu().numpy(), ref.cpu().numpy()
    if got.shape != ref.shape or not np.allclose(got, ref, rtol=rtol,
                                                 atol=atol):
        raise AssertionError(f"{what}: sharded vs single-device differ")


def _multichip_checks(mesh, time_ax, shift_ax) -> str:
    """The five checks of the JAX dry run on ``mesh``, against the
    single-device ops on this rank."""
    dev = device_of(mesh)
    tsize, ssize = mesh[time_ax].size(), mesh[shift_ax].size()
    rng = np.random.default_rng(0)
    dec = nch = 4
    ntaps = 4 * nch
    lcm = np.lcm(tsize * dec, ssize)
    n_wide = int(max(4 * ntaps * tsize, 8 * lcm, 512) // lcm * lcm)
    f_tap = torch.tensor(sps.firwin(ntaps, 1.0 / dec), dtype=torch.float32,
                         device=dev)
    x = torch.from_numpy((rng.standard_normal(n_wide) + 1j
                          * rng.standard_normal(n_wide)).astype(
        np.complex64)).to(dev)

    # 1) time-sharded WOLA with halo exchange
    ch = sharded_wola(f_tap, x, dec, nch, mesh, axis=time_ax).full_tensor()
    _close(ch, wola(f_tap, x, dec, nch), what="sharded_wola")
    # 2) time-sharded overlap-save FIR
    y = sharded_lfilter(f_tap, x, mesh, axis=time_ax).full_tensor()
    _close(y, lfilter_fir(f_tap, x), what="sharded_lfilter")
    # 3) shift-sharded CAF search + scalar peak reduction
    cutout = x[100:228]
    nshifts = max(16 * ssize, 64)       # always covers the planted shift 100
    shifts = np.arange(50, 50 + nshifts)
    qf2, _ = sharded_fast_xcorr(cutout, x, shifts, mesh, axis=shift_ax)
    peak, best_shift, _ = sharded_caf_peak(cutout, x, shifts, mesh,
                                           axis=shift_ax)
    ref_qf2, _ = fast_xcorr(cutout, x, freqsearch=True, shifts=shifts)
    _close(qf2.full_tensor(), ref_qf2, atol=0.0, rtol=1e-4,
           what="sharded_fast_xcorr")
    if best_shift != 100:
        raise AssertionError(f"sharded_caf_peak at shift {best_shift}")
    # 4) channel-sharded WOLA (independent captures over the shift axis)
    xm = torch.stack([torch.roll(x, 7 * c) for c in range(2 * ssize)])
    chm = sharded_multichannel_wola(f_tap, xm, dec, nch, mesh,
                                    axis=shift_ax).full_tensor()
    _close(chm[1], wola(f_tap, xm[1], dec, nch),
           what="sharded_multichannel_wola")
    # 5) shift-sharded group xcorr over a CZT CAF grid
    fs, glen, ngrp = 1e5, 32, 3
    gstarts = np.arange(ngrp) * 96
    span = int(gstarts[-1] + glen)
    bw = fs / glen / 2
    gx = GroupXcorrCZT(x[40: 40 + span].cpu().numpy(), gstarts,
                       np.full(ngrp, glen), -4 * bw, 3 * bw, bw, fs,
                       device=dev)
    gshifts = np.arange(8, 8 + 8 * ssize)
    gcaf, _ = sharded_group_xcorr_czt(gx, x, gshifts, mesh, axis=shift_ax)
    _close(gcaf.full_tensor(), gx.xcorr(x, gshifts)[0], atol=1e-7,
           rtol=1e-4, what="sharded_group_xcorr_czt")
    return (f"mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))}: wola/fir "
            f"halo exchange + shift-sharded CAF peak (QF2={peak:.3f} at "
            f"shift {best_shift}) + channel-sharded WOLA + shift-sharded "
            f"group xcorr")


def _multichip_rank(rank, world, device_type):
    lines = [_multichip_checks(make_mesh((world,), ("dsp",), device_type),
                               "dsp", "dsp")]
    if world >= 4 and world % 2 == 0:
        lines.append(_multichip_checks(
            make_mesh((2, world // 2), ("time", "shifts"), device_type),
            "time", "shifts"))
    if rank == 0:
        for line in lines:
            print(f"dryrun_multichip({world}): {line} OK", flush=True)


def dryrun_multichip(n_devices: int, device_type: str = "cuda",
                     timeout: float = 300.0) -> None:
    """Run the layer's five exact-parity checks on a spawned
    ``n_devices``-rank group: NCCL, a card a rank, for ``cuda``; gloo for
    ``cpu``. Raises if any check fails on any rank."""
    check_device_type(device_type)
    run_ranks(_multichip_rank, n_devices, (device_type,),
              BACKENDS[device_type], timeout)


def _cluster_rank(rank, world, outdir, device_type):
    """The 2-rank cluster check of one rank: FIR and WOLA with the halo
    crossing the process boundary and the CAF peak reduced across it, the
    inputs made global by ``shard_local_blocks``; writes its errors and
    peak to ``outdir/res_{rank}.json``."""
    if not init_distributed():          # idempotent: already in the group
        raise AssertionError("init_distributed: not multi-process")
    mesh = flat_mesh("dsp", device_type)
    dev = device_of(mesh)
    # one deterministic scene in every process; each process owns a block
    rng = np.random.default_rng(7)
    total = 4096
    x_full = (rng.standard_normal(total) + 1j * rng.standard_normal(total)
              ).astype(np.complex64)
    lo, hi = process_shard_bounds(total, world, rank)
    gx = shard_local_blocks(x_full[lo:hi], mesh, "dsp")
    xt = torch.from_numpy(x_full).to(dev)

    # 1) time-sharded FIR across the process boundary == local reference
    taps = torch.from_numpy(np.hanning(33).astype(np.float32)).to(dev)
    y = sharded_lfilter(taps, gx, mesh, "dsp").to_local()
    err_fir = float((y - lfilter_fir(taps, xt)[lo:hi]).abs().max())
    # 2) time-sharded WOLA across the process boundary == local reference
    dec = nch = 8
    f_tap = torch.from_numpy(np.hanning(64).astype(np.float32)).to(dev)
    ch = sharded_wola(f_tap, gx, dec, nch, mesh, "dsp").to_local()
    ch_ref = wola(f_tap, xt, dec, nch)[lo // dec: hi // dec]
    err_wola = float((ch - ch_ref).abs().max())
    # 3) shift-sharded CAF peak reduced across processes == local argmax
    cut = xt[1000:1512]
    shifts = np.arange(512, 1536, dtype=np.int32)
    per = shifts.size // world
    gshifts = shard_local_blocks(shifts[rank * per: (rank + 1) * per], mesh,
                                 "dsp")
    peak, sbest, fbest = sharded_caf_peak(cut, xt, gshifts, mesh, "dsp",
                                          batch_size=64)
    ref_qf2, ref_bins = fast_xcorr(cut, xt, True, shifts=shifts,
                                   batch_size=64)
    i = int(torch.argmax(ref_qf2))
    res = dict(rank=rank, err_fir=err_fir, err_wola=err_wola, peak=peak,
               sbest=sbest, fbest=fbest, ref=[float(ref_qf2[i]),
                                              int(shifts[i]),
                                              int(ref_bins[i])],
               route=list(sharded_caf_peak.route),
               pipeline=multihost_pipeline.main(["--device", device_type]))
    (Path(outdir) / f"res_{rank}.json").write_text(json.dumps(res))


def check_cluster(results: list[dict]) -> None:
    """The 2-rank cluster's assertions (``tests/test_multihost.py``): FIR
    and WOLA equal to the single-device calls across the boundary, the same
    peak on both ranks at the planted shift 1000, bin 0; and the
    ``multihost_pipeline`` walkthrough's peak and blocks on each rank."""
    for r in results:
        if not (r["err_fir"] < 1e-5 and r["err_wola"] < 1e-4):
            raise AssertionError(f"rank {r['rank']}: FIR err {r['err_fir']}"
                                 f", WOLA err {r['err_wola']}")
    a, b = results
    if not (a["sbest"] == b["sbest"] == 1000 and a["fbest"] == b["fbest"] == 0
            and a["peak"] == b["peak"] and a["peak"] > 0.99
            and [a["peak"], a["sbest"], a["fbest"]] == a["ref"]):
        raise AssertionError(f"cluster peaks {results}")
    for r in results:                  # the walkthrough, on both ranks
        p = r["pipeline"]
        if not (p["processes"] == 2 and (p["shift"], p["bin"]) == (0, 0)
                and p["blocks"] == 8
                and p["filtered"] == [multihost_pipeline.TOTAL]):
            raise AssertionError(f"rank {r['rank']} walkthrough {p}")


def dryrun_multiprocess(device_type: str = "cuda",
                        timeout: float = 300.0) -> list[dict]:
    """Run the 2-rank cluster check (a card a rank for ``cuda``, gloo on
    the CPU for ``cpu``) and assert on its results; returns them."""
    check_device_type(device_type)
    with tempfile.TemporaryDirectory() as out:
        run_ranks(_cluster_rank, 2, (out, device_type),
                  BACKENDS[device_type], timeout)
        results = [json.loads((Path(out) / f"res_{i}.json").read_text())
                   for i in range(2)]
    check_cluster(results)
    print("dryrun_multiprocess: 2-rank cluster parity OK")
    return results


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 4,
                     sys.argv[2] if len(sys.argv) > 2 else "cuda")

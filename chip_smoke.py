#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

1. Builds the hand-written Hopper kernels from ``pydsproutines_tpu_torch/
   csrc`` (nvcc, sm_90a) and prints the build time.
2. Checks each kernel against its plain PyTorch twin on the card at the
   receiver's shapes: the WOLA channelizer at 131,072 rows x 64 channels with
   2048 taps; the CAF peak search at n = 1,000,000 x 128 shifts and at
   n = 1024 x 256 shifts on a 131,072-sample channel.
3. Drives the main path through the public entry points, with every kernel's
   launch count set to 0 first: ``WidebandReceiver(64 ch, 2048 taps,
   template 1024, 256 shifts).run`` on an 8,388,608-sample wideband scene
   (a QPSK template on channel 1), then ``fast_xcorr(freqsearch=True)`` at
   1M x 128 with a planted peak. Checks the routes, the launch counts, the
   planted channel, shift and bin, and the receiver's answer against the
   same receiver run on the CPU (plain twins).
4. Times each kernel, its twin and the whole receiver step on CUDA events
   (one warm-up, median of >= 3), each line tagged with the card's name and
   power limit.

Prints a JSON line of per-kernel results, the card's name and power limit,
and as its last line ``{"ok": true, "device": {...}}``. Any failed phase
raises, so the script exits non-zero and prints no result; so does a
machine without CUDA.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

# Tolerances, with their reasons:
# - WOLA kernel vs twin: both f32; the twin's IDFT is torch.fft, the
#   kernel's a direct f32 sum, so they differ by summation order only:
#   max|d| / max|ref| < 1e-5 (the CPU parity tests' bound).
WOLA_RTOL = 1e-5
# - CAF peak |X|^2 per shift, kernel vs twin: the kernel's two-stage f32 DFT
#   against f32 tables vs cuFFT; relative error of each shift's maximum
#   < 1e-4 (the QF^2 tolerance of the CPU parity tests). Peak shift and bin
#   must be equal.
CAF_RTOL = 1e-4

NCH, TAPS, ROWS = 64, 2048, 131072
N_BIG, SHIFTS_BIG = 1_000_000, 128
N_RX, SHIFTS_RX, CHAN_LEN = 1024, 256, 131072


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def rel_err(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max())


def planted_sweep(rng, n, num_shifts, s_star, f_star, device):
    """cutout, rx with cutout * exp(2*pi*i*f_star*t/n) planted at shift
    s_star in noise: the peak is at (s_star, bin f_star)."""
    import numpy as np
    import torch
    cut = (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    rxlen = n + num_shifts - 1
    rx = 0.5 * (rng.standard_normal(rxlen) + 1j * rng.standard_normal(rxlen))
    t = np.arange(n)
    rx[s_star: s_star + n] += cut * np.exp(2j * np.pi * f_star * t / n)
    return (torch.from_numpy(cut.astype(np.complex64)).to(device),
            torch.from_numpy(rx.astype(np.complex64)).to(device))


def wideband_scene(rcv, n_wide: int, seed: int):
    """(template_ri, rx_ri) on the receiver's device: a QPSK template held
    for one channel-rate sample per symbol (a rectangular pulse of Dec
    samples), on the channel-1 tone, in noise. Unlike the impulse-train
    example of ``example_inputs``, its energy sits in channel 1, so the
    strongest channel is the planted one."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    dec = rcv.dec
    syms = np.exp(1j * (np.pi / 2) * rng.integers(0, 4, rcv.template_len))
    rx = 0.1 * (rng.standard_normal(n_wide) + 1j * rng.standard_normal(n_wide))
    start = (rcv.num_shifts // 2 + rcv.num_taps // dec) * dec
    span = slice(start, start + rcv.template_len * dec)
    t = np.arange(span.start, span.stop)
    rx[span] += np.repeat(syms, dec) * np.exp(2j * np.pi * t / rcv.num_channels)
    tri = np.stack([syms.real, syms.imag]).astype(np.float32)
    xri = np.stack([rx.real, rx.imag]).astype(np.float32)
    dev = rcv.f_tap.device
    return torch.from_numpy(tri).to(dev), torch.from_numpy(xri).to(dev)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing to measure",
              file=sys.stderr)
        return 1
    import numpy as np
    from scipy import signal as sps

    from pydsproutines_tpu_torch.models import WidebandReceiver
    from pydsproutines_tpu_torch.ops.hopper import _build
    from pydsproutines_tpu_torch.ops.hopper.fused_xcorr import (caf_peak,
                                                                caf_peak_plain)
    from pydsproutines_tpu_torch.ops.hopper.wola_fused import (wola_fused,
                                                               wola_plain)
    from pydsproutines_tpu_torch.ops.xcorr import fast_xcorr
    from pydsproutines_tpu_torch.utils.timing import Timer, median_ms

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    tag = f"[{card}]"
    rng = np.random.default_rng(2024)

    # 1) build ---------------------------------------------------------------
    t0 = time.perf_counter()
    _build.library()
    print(f"build: {time.perf_counter() - t0:.2f} s "
          f"(nvcc {_build.build_info.seconds:.2f} s, "
          f"compiled={_build.build_info.compiled})")
    for line in _build.build_info.log.splitlines():
        if "registers" in line or "Function properties" in line:
            print("  ptxas:", line.strip())

    # 2) kernels vs plain twins at the slice's shapes --------------------------
    h = torch.from_numpy(sps.firwin(TAPS, 1.0 / NCH).astype(np.float32)).to(dev)
    xw = torch.from_numpy(
        (rng.standard_normal(ROWS * NCH) + 1j * rng.standard_normal(ROWS * NCH)
         ).astype(np.complex64)).to(dev)
    got, ref = wola_fused(h, xw, NCH), wola_plain(h, xw, NCH, NCH)
    torch.cuda.synchronize()
    wola_err = rel_err(got, ref)
    wola_abs = float((got - ref).abs().max())
    check(got.shape == (ROWS, NCH) and bool(torch.isfinite(got.real).all()),
          "WOLA output shape or finiteness")
    check(wola_err < WOLA_RTOL, f"WOLA kernel vs twin rel err {wola_err:.3e}")
    wola_ms = median_ms(lambda: wola_fused(h, xw, NCH), reps=5)
    wola_plain_ms = median_ms(lambda: wola_plain(h, xw, NCH, NCH), reps=5)
    print(f"wola {ROWS}x{NCH} ch, {TAPS} taps: kernel {wola_ms:.4f} ms, "
          f"plain {wola_plain_ms:.4f} ms, rel err {wola_err:.3e} {tag}")

    caf = {}
    for n, nshift, s_star, f_star, rxlen in (
            (N_BIG, SHIFTS_BIG, 77, 12345, None),
            (N_RX, SHIFTS_RX, 100, 5, CHAN_LEN)):
        cut, rx = planted_sweep(rng, n, rxlen - n + 1 if rxlen else nshift,
                                s_star, f_star, dev)
        cc = cut.conj().resolve_conj().contiguous()
        km, kb = caf_peak(rx, cc, 0, 1, nshift, 128)
        pm, pb = caf_peak_plain(rx, cc, 0, 1, nshift, 128)
        torch.cuda.synchronize()
        err = float(((km - pm).abs() / pm).max())
        check(bool(torch.isfinite(km).all()) and km.shape == (nshift,),
              f"CAF n={n} output shape or finiteness")
        check(err < CAF_RTOL, f"CAF n={n} kernel vs twin rel err {err:.3e}")
        ks, ps = int(torch.argmax(km)), int(torch.argmax(pm))
        check(ks == ps == s_star, f"CAF n={n} peak shift {ks} / {ps}")
        check(int(kb[ks]) == int(pb[ps]) == f_star,
              f"CAF n={n} peak bin {int(kb[ks])} / {int(pb[ps])}")
        reps = 3 if n == N_BIG else 5
        k_ms = median_ms(lambda: caf_peak(rx, cc, 0, 1, nshift, 128), reps=reps)
        p_ms = median_ms(lambda: caf_peak_plain(rx, cc, 0, 1, nshift, 128),
                         reps=reps)
        # absolute error on the QF^2 scale (0..1) users threshold
        power = torch.cumsum((rx.abs() ** 2).double(), 0)
        power = torch.cat([power.new_zeros(1), power])
        norm = float((cut.abs() ** 2).sum(dtype=torch.float64)) * (
            power[n: n + nshift] - power[:nshift])
        caf[n] = {"ms": k_ms, "plain_ms": p_ms, "rel_err": err,
                  "max_abs_err": float(((km.double() - pm.double())
                                        / norm).abs().max()),
                  "cut": cut, "rx": rx, "s_star": s_star, "f_star": f_star}
        print(f"caf n={n} x {nshift} shifts: kernel {k_ms:.4f} ms, plain "
              f"{p_ms:.4f} ms, per-shift rel err {err:.3e}, peak at shift {ks} "
              f"bin {int(kb[ks])} {tag}")

    # 3) the main path, through the public entry points ------------------------
    rcv = WidebandReceiver(num_channels=NCH, num_taps=TAPS, template_len=N_RX,
                           num_shifts=SHIFTS_RX, osr=4, demod_syms=128, m=4,
                           device=dev)
    tri, xri = wideband_scene(rcv, ROWS * NCH, seed=7)
    big = caf[N_BIG]
    wola_fused.launches = 0
    caf_peak.launches = 0
    timer = Timer().start()
    out = rcv.run(tri, xri)
    rcv_ms = timer.evt("receiver run")
    qf2, bins = fast_xcorr(big["cut"], big["rx"], freqsearch=True,
                           shifts=torch.arange(SHIFTS_BIG, device=dev))
    i_big = int(torch.argmax(qf2))
    xcorr_ms = timer.evt("fast_xcorr 1M x 128")
    launches = {"wola_fused": wola_fused.launches,
                "caf_peak": caf_peak.launches}
    print(f"main path: receiver run {rcv_ms:.2f} ms, fast_xcorr "
          f"{xcorr_ms:.2f} ms (first calls), launches {launches} {tag}")
    print("receiver:", json.dumps({k: v for k, v in out.items()
                                   if k not in ("channel_energy_db",
                                                "demod_syms")}))
    check(launches["wola_fused"] > 0 and launches["caf_peak"] > 0,
          f"a kernel of the main path never launched: {launches}")
    check(out["kernel_launches"]["wola_fused"] > 0
          and out["kernel_launches"]["caf_peak"] > 0,
          f"receiver launches {out['kernel_launches']}")
    check(out["xcorr_path"] == "fused-hopper" == out["wola_path"],
          f"routes {out['xcorr_path']} / {out['wola_path']}")
    check(out["best_channel"] == 1, f"best channel {out['best_channel']}")
    check(len(out["channel_energy_db"]) == NCH
          and bool(np.isfinite(out["channel_energy_db"]).all())
          and np.isfinite(out["qf2_peak"]) and 0 < out["qf2_peak"] <= 1,
          "receiver energies / QF^2 not finite or out of range")
    check(i_big == big["s_star"] and int(bins[i_big]) == big["f_star"],
          f"fast_xcorr 1M peak at shift {i_big} bin {int(bins[i_big])}")
    check(qf2.shape == (SHIFTS_BIG,) and bool(torch.isfinite(qf2).all()),
          "fast_xcorr QF^2 shape or finiteness")

    # the same receiver and input on the CPU: plain twins throughout
    ref = WidebandReceiver.from_numpy_params(
        {"f_tap": rcv.f_tap.cpu().numpy(), "num_channels": NCH,
         "num_taps": TAPS, "template_len": N_RX, "num_shifts": SHIFTS_RX,
         "osr": 4, "demod_syms": 128, "m": 4}).run(tri.cpu(), xri.cpu())
    for key in ("best_channel", "best_shift", "freq_bin", "demod_syms"):
        check(out[key] == ref[key], f"receiver {key}: card {out[key]} vs "
              f"plain twin {ref[key]}")
    qerr = abs(out["qf2_peak"] - ref["qf2_peak"]) / ref["qf2_peak"]
    check(qerr < CAF_RTOL, f"receiver QF^2 rel err {qerr:.3e}")

    # 4) whole-step time -------------------------------------------------------
    step_ms = median_ms(lambda: rcv.step(tri, xri), reps=5)
    print(f"receiver step, {ROWS * NCH} samples: {step_ms:.4f} ms "
          f"({ROWS * NCH / step_ms / 1e6:.3f} GS/s) {tag}")

    rx_caf = caf[N_RX]
    print(json.dumps({"kernels": [
        {"name": "wola_fused", "route": "cuda",
         "source": "pydsproutines_tpu_torch/csrc/wola_fused.cu",
         "replaces": "pydsproutines_tpu/ops/pallas/wola_fused.py:99",
         "shape": f"{ROWS}x{NCH} ch, {TAPS} taps",
         "launches": launches["wola_fused"], "max_abs_err": wola_abs,
         "ms": wola_ms, "plain_ms": wola_plain_ms},
        {"name": "caf_peak", "route": "cuda",
         "source": "pydsproutines_tpu_torch/csrc/fused_xcorr.cu",
         "replaces": "pydsproutines_tpu/ops/pallas/fused_xcorr.py:60",
         "shape": f"n={N_BIG} x {SHIFTS_BIG} shifts",
         "launches": launches["caf_peak"], "max_abs_err": big["max_abs_err"],
         "ms": big["ms"], "plain_ms": big["plain_ms"],
         "receiver_shape": {"shape": f"n={N_RX} x {SHIFTS_RX} shifts",
                            "max_abs_err": rx_caf["max_abs_err"],
                            "ms": rx_caf["ms"],
                            "plain_ms": rx_caf["plain_ms"]}},
    ], "receiver_step_ms": step_ms, "card": card}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Package-level properties of the PyTorch port: it never imports JAX, its
routers pick the Hopper kernels for CUDA tensors, and a kernel wrapper never
falls back to its plain twin for a tensor that is not on the CPU."""

import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import pydsproutines_tpu_torch
from pydsproutines_tpu_torch.ops.filters import (select_medfilt_path,
                                                 select_upfirdn_path)
from pydsproutines_tpu_torch.ops.groupxcorr import select_group_caf_path
from pydsproutines_tpu_torch.ops.hopper import (_build, fft_peak, fused_caf3,
                                                fused_xcorr, group_caf,
                                                medfilt, sliding, upfirdn,
                                                wola_fused)
from pydsproutines_tpu_torch.ops.wola import select_wola_path
from pydsproutines_tpu_torch.ops.xcorr import select_xcorr_path

PKG = Path(pydsproutines_tpu_torch.__file__).parent


def test_import_leaves_jax_out():
    code = ("import sys, pydsproutines_tpu_torch; "
            "assert 'jax' not in sys.modules, 'jax imported'; "
            "assert not any(m.startswith('pydsproutines_tpu.') or "
            "m == 'pydsproutines_tpu' for m in sys.modules)")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   cwd=PKG.parent)


def test_no_source_file_imports_jax():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|pydsproutines_tpu)\b",
                         re.M)
    offenders = [str(p) for p in PKG.rglob("*.py")
                 if pattern.search(p.read_text())]
    assert offenders == []


@pytest.mark.parametrize("n,step,path", [
    (1024, 1, "fused-hopper"),           # the receiver's sweep
    (1_000_000, 1, "fused-hopper"),
    (4096, 3, "fused-hopper"),
    (4099, 1, "plain"),                  # prime: no two-factor split
    (4099, None, "plain"),
    (1024, None, "fused3-hopper"),       # a listed window of one block
    (65536, None, "peak-kernel-hopper"),  # non-uniform shifts, two passes
    (1_000_000, None, "peak-kernel-hopper"),
    (10_000_000, 1, "fused3-hopper"),    # 200 x 200 x 250
    (10_000_000, None, "fused3-hopper"),
    (5**10, 1, "fused3-hopper"),         # "planes" in the JAX package
    (2**21 - 1, 1, "fused-hopper"),      # below the three-stage gate
])
def test_xcorr_router_on_cuda(n, step, path):
    got, reason = select_xcorr_path(n, torch.complex64, step, "cuda")
    assert got == path, reason
    if path == "fused-hopper" and n < 4096:
        assert "gate does not apply" in reason
    if path == "fused3-hopper" and n >= 2**21:
        assert "lane rule" in reason and "x" in reason
    if path == "fused3-hopper" and n < 2**21:
        assert "one-pass" in reason and "two passes" in reason
    if path == "peak-kernel-hopper":
        assert "twiddle on load" in reason
    if path == "plain":
        assert "no two-factor split" in reason


def test_xcorr_router_modes():
    assert select_xcorr_path(4096, torch.complex64, 1, "cuda",
                             freqsearch=False)[0] == "dot"
    assert select_xcorr_path(4096, torch.complex64, 1, "cuda",
                             output_caf=True)[0] == "caf"
    path, reason = select_xcorr_path(10_000_000, torch.complex64, 1, "cuda",
                                     abs_result=False)
    assert path == "plain" and "complex peaks" in reason


def test_routers_on_cpu_and_other_dtypes():
    assert select_xcorr_path(1024, torch.complex64, 1, "cpu")[0] == "plain"
    assert select_xcorr_path(1024, torch.complex128, 1, "cuda")[0] == "plain"
    assert select_wola_path(64, 64, "cpu")[0] == "plain"


def test_kernel_launch_without_cuda_raises():
    """The CUDA launch paths raise when there is no GPU; they never hand the
    work to the plain twin."""
    if torch.cuda.is_available():
        pytest.skip("CUDA present: this checks the CPU-only behaviour")
    x = torch.zeros(64 * 8, dtype=torch.complex64)
    h = torch.ones(128)
    counters = (wola_fused.wola_fused, fused_xcorr.caf_peak,
                fused_caf3.caf3_peak, fft_peak.stage2_peak)
    before = [c.launches for c in counters]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        wola_fused._wola_fused_cuda(h, x, 64)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fused_xcorr._caf_peak_cuda(x, x[:64].clone(), 0, 1, 4, 4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fused_caf3._caf3_peak_cuda(torch.zeros(2**21 + 4, dtype=x.dtype),
                                   torch.zeros(2**21, dtype=x.dtype),
                                   torch.arange(4), 4)
    f1 = torch.zeros((2, 4, 8), dtype=x.dtype)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fft_peak._stage2_peak_cuda(f1, f1[0], (4, 8))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        group_caf._group_caf_cuda(x, torch.arange(4), torch.arange(2),
                                  torch.zeros((16, 4), dtype=x.dtype), 4)
    with pytest.raises(RuntimeError):
        _build.library()
    assert [c.launches for c in counters] == before


def test_wrappers_refuse_other_devices():
    x = torch.zeros(64 * 8, dtype=torch.complex64, device="meta")
    h = torch.ones(128, device="meta")
    offs = torch.arange(4, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        wola_fused.wola_fused(h, x, 64)
    with pytest.raises(ValueError, match="unsupported device"):
        fused_xcorr.caf_peak(x, x[:64], 0, 1, 4, 4)
    with pytest.raises(ValueError, match="unsupported device"):
        fused_caf3.caf3_peak(x, x[:64], offs)
    with pytest.raises(ValueError, match="unsupported device"):
        fft_peak.peak_sweep(x, x[:64], offs)
    f1 = torch.zeros((2, 4, 8), dtype=torch.complex64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fft_peak.stage2_peak(f1, f1[0])
    with pytest.raises(ValueError, match="unsupported device"):
        fft_peak.window_columns(x, x[:64], offs)


def test_build_sources_are_the_package_csrc():
    names = [p.name for p in _build.sources()]
    assert names == ["fft_peak.cu", "fused_caf3.cu", "fused_xcorr.cu",
                     "group_caf.cu", "medfilt.cu", "sliding.cu", "upfirdn.cu",
                     "wola_fused.cu"]
    assert [p.name for p in _build.headers()] == ["fft_smem.cuh",
                                                  "peak.cuh"]
    text = "".join(p.read_text() for p in _build.sources() + _build.headers())
    assert "torch/extension.h" not in text
    assert "cufft" not in text.lower() and "cublas" not in text.lower()
    for name in _build._SIGNATURES:      # every bound entry point exists
        assert f'extern "C" int {name}(' in text


def test_build_digest_covers_the_headers(tmp_path, monkeypatch):
    """An edited shared header must give a new library name, or a stale
    library would be loaded."""
    for src in _build.sources() + _build.headers():
        (tmp_path / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = _build._digest()
    header = tmp_path / "peak.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    assert _build._digest() != before


def test_package_data_ships_the_headers():
    text = (PKG.parent / "pyproject.toml").read_text()
    assert '"csrc/*.cu", "csrc/*.cuh"' in text


@pytest.mark.parametrize("n,taps,up,down,dtype", [
    (4_194_304, 730, 5, 4, torch.float32),      # the chain's geometry
    (4_194_304, 730, 5, 4, torch.complex64),
    (1000, 16, 2, 3, torch.float64),
    (1, 1, 8, 7, torch.float32),                # far below the TPU gate
    (3000, 30_000, 1, 1, torch.float32),        # taps past shared memory
    (50_000, 9, 1, 20_000, torch.float32),      # span past shared memory
    (100, 5, 3, 2, torch.float16),              # computed in float32
])
def test_upfirdn_router_on_cuda(n, taps, up, down, dtype):
    path, reason = select_upfirdn_path(n, taps, up, down, dtype, "cuda")
    assert path == "upfirdn-hopper", reason
    assert "gate" in reason and "does not apply" in reason
    assert "any tap length" in reason
    rdt = torch.float64 if dtype == torch.float64 else torch.float32
    assert str(rdt) in reason


@pytest.mark.parametrize("ndim,dtype,k,path,why", [
    (1, torch.float32, 129, "medfilt-hopper", "32 key bits"),
    (1, torch.float64, 1023, "medfilt-hopper", "64 key bits"),
    (1, torch.float32, 60_001, "medfilt-hopper", "any odd k"),
    (2, torch.float32, 5, "plain", "1-D"),
    (1, torch.int64, 5, "plain", "integer"),
    (1, torch.float16, 5, "medfilt-hopper", "filtered as float32"),
    (1, torch.bfloat16, 5, "medfilt-hopper", "filtered as float32"),
])
def test_medfilt_router_on_cuda(ndim, dtype, k, path, why):
    got, reason = select_medfilt_path(ndim, dtype, "cuda", k)
    assert got == path and why in reason, reason


def test_filter_routers_on_cpu():
    assert select_upfirdn_path(4096, 95, 5, 4, torch.float32,
                               "cpu")[0] == "plain"
    assert select_medfilt_path(1, torch.float32, "cpu", 129)[0] == "plain"


def test_filter_kernel_launches_without_cuda_raise():
    """The upfirdn and medfilt launch paths raise when there is no GPU; they
    never hand the work to the plain twin."""
    if torch.cuda.is_available():
        pytest.skip("CUDA present: this checks the CPU-only behaviour")
    x = torch.zeros(64, dtype=torch.float32)
    counters = (upfirdn.upfirdn_planes, medfilt.medfilt_kernel)
    before = [c.launches for c in counters]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        upfirdn._upfirdn_cuda((x, x), torch.ones(5), 5, 4, 80, None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        medfilt._medfilt_cuda(x, 5)
    assert [c.launches for c in counters] == before


def test_filter_wrappers_refuse_other_devices():
    x = torch.zeros(64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        upfirdn.upfirdn_planes((x,), torch.ones(5, device="meta"), 5, 4)
    with pytest.raises(ValueError, match="unsupported device"):
        medfilt.medfilt_kernel(x, 5)


def test_filter_wrappers_check_their_inputs():
    x = torch.zeros(64)
    with pytest.raises(ValueError, match="odd"):
        medfilt.medfilt_kernel(x, 4)
    with pytest.raises(ValueError, match="1-D real"):
        medfilt.medfilt_kernel(x.reshape(8, 8), 3)
    with pytest.raises(ValueError, match="real float planes"):
        upfirdn.upfirdn_planes((x.to(torch.complex64),), torch.ones(3), 1, 1)
    with pytest.raises(ValueError, match="taps are"):
        upfirdn.upfirdn_planes((x,), torch.ones(3, dtype=torch.float64), 1, 1)
    with pytest.raises(ValueError, match="differ"):
        upfirdn.upfirdn_planes((x, x[:32]), torch.ones(3), 1, 1)


@pytest.mark.parametrize("dtype,device,tones,fused,path,why", [
    (torch.complex64, "cuda", True, None, "group-caf-hopper",
     "VMEM gate (m % 128, batch % 8, 88 MB) does not apply"),
    (torch.complex64, "cuda", True, True, "group-caf-hopper", "f32"),
    (torch.complex64, "cuda", True, False, "plain", "parity tier"),
    (torch.complex64, "cpu", True, None, "plain", "cpu tensor"),
    (torch.complex128, "cuda", True, None, "plain", "complex64"),
    (torch.complex64, "cuda", False, None, "plain", "Bluestein"),
])
def test_group_caf_router(dtype, device, tones, fused, path, why):
    got, reason = select_group_caf_path(8, 4096, 128, dtype, device, tones,
                                        fused)
    assert got == path and why in reason, reason


def test_new_kernel_launches_without_cuda_raise():
    """The group CAF and sliding launch paths raise when there is no GPU;
    they never hand the work to the plain twin."""
    if torch.cuda.is_available():
        pytest.skip("CUDA present: this checks the CPU-only behaviour")
    x = torch.zeros(512, dtype=torch.complex64)
    counters = (group_caf.group_caf, sliding.sliding_multiply_normalised)
    before = [c.launches for c in counters]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        group_caf._group_caf_cuda(x, torch.arange(4), torch.tensor([0, 100]),
                                  torch.zeros((2 * 64, 8), dtype=x.dtype), 8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sliding._sliding_cuda(x, torch.ones((2, 16), dtype=x.dtype))
    assert [c.launches for c in counters] == before


def _constructors(device=None):
    """Every class of the port that holds tensors, built on ``device``."""
    import numpy as np
    from pydsproutines_tpu_torch import ops
    from pydsproutines_tpu_torch.models import WidebandReceiver
    from pydsproutines_tpu_torch.ops.xcorr import GenXcorr
    y = np.ones(64, np.complex64)
    return {
        "WidebandReceiver": lambda: WidebandReceiver(16, 128, device=device),
        "WidebandReceiver.from_numpy_params":
            lambda: WidebandReceiver.from_numpy_params(
                {"f_tap": np.ones(128), "num_channels": 16,
                 "num_taps": 128}, device=device),
        "Channeliser": lambda: ops.Channeliser(32, 8, device=device),
        "StreamFilter": lambda: ops.StreamFilter(np.ones(4), device=device),
        "StreamFilter.from_numpy_params":
            lambda: ops.StreamFilter.from_numpy_params(
                {"taps": np.ones(4), "delay": np.zeros(4, np.complex64)}, device=device),
        "StreamUpfirdn": lambda: ops.StreamUpfirdn(np.ones(4), 2, 3, 8,
                                                   device=device),
        "StreamUpfirdn.from_numpy_params":
            lambda: ops.StreamUpfirdn.from_numpy_params(
                {"taps": np.ones(4), "up": 2, "down": 3, "memory": 8,
                 "delay": np.zeros(8, np.complex64)}, device=device),
        "BurstDetector.from_numpy_params":
            lambda: ops.BurstDetector.from_numpy_params({"medfiltlen": 5},
                                                        device=device),
        "CZT": lambda: ops.CZT(64, -1.0, 1.0, 0.5, 8.0, device=device),
        "IntegerMultipleFFT": lambda: ops.IntegerMultipleFFT(2, 16, device=device),
        "GroupXcorrCZT": lambda: ops.GroupXcorrCZT(y, [0, 32], [16, 16],
                                                   -1.0, 1.0, 0.5, 8.0,
                                                   device=device),
        "GroupXcorrFFT": lambda: ops.GroupXcorrFFT(y.reshape(4, 16),
                                                   [0, 20, 40, 60], 1.0,
                                                   device=device),
        "GroupXcorr": lambda: ops.GroupXcorr(y, [0, 32], [16, 16],
                                             [0.0, 0.1], 1.0, device=device),
        "TemplateCrossCorrelator":
            lambda: ops.TemplateCrossCorrelator(y.reshape(2, 32), 128,
                                                device=device),
        "GroupXcorrCZTPermutations":
            lambda: ops.GroupXcorrCZTPermutations(
                y.reshape(2, 32), [0, 1], [0, 40], -0.1, 0.1, 0.05, 1.0,
                device=device),
        "MultiPreambleCorrelator":
            lambda: ops.MultiPreambleCorrelator(y.reshape(2, 32), 2,
                                                device=device),
        "GenXcorr": lambda: GenXcorr([0.0, 0.5], 1.0, 64, device=device),
    }


@pytest.mark.parametrize("name", sorted(_constructors()))
def test_constructors_default_to_cuda(monkeypatch, name):
    """With no device every constructor targets the card: without CUDA it
    raises (never a silent CPU run); with device="cpu" it builds on the
    CPU."""
    from pydsproutines_tpu_torch.utils.device import resolve_device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _constructors()[name]()
    _constructors("cpu")[name]()
    assert resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert resolve_device(None) == torch.device("cuda", 0)
    assert resolve_device("cuda") == torch.device("cuda", 0)

"""Package-level properties of the PyTorch port: it never imports JAX, its
routers pick the Hopper kernels for CUDA tensors, and a kernel wrapper never
falls back to its plain twin for a tensor that is not on the CPU."""

import ast
import importlib
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
    """Importing the port, its ``io``, its ``viz`` (every viewer module)
    and its ``parallel`` (the dry runs and the walkthrough too) loads
    neither JAX, the JAX package nor matplotlib."""
    code = ("import sys, pydsproutines_tpu_torch, pydsproutines_tpu_torch.io, "
            "pydsproutines_tpu_torch.viz, pydsproutines_tpu_torch.viz.plots, "
            "pydsproutines_tpu_torch.viz.xcorr_viewer, "
            "pydsproutines_tpu_torch.viz.configeditor, "
            "pydsproutines_tpu_torch.viz.webviewer, "
            "pydsproutines_tpu_torch.parallel.dryrun, "
            "pydsproutines_tpu_torch.parallel.multihost_pipeline; "
            "assert 'jax' not in sys.modules, 'jax imported'; "
            "assert 'matplotlib' not in sys.modules, 'matplotlib imported'; "
            "assert not any(m.startswith('pydsproutines_tpu.') or "
            "m == 'pydsproutines_tpu' for m in sys.modules)")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   cwd=PKG.parent)


def _jax_all(sub: str) -> list[str]:
    """``__all__`` of the JAX package's ``sub/__init__.py``, read by ast
    (importing it would load JAX)."""
    tree = ast.parse((PKG.parent / "pydsproutines_tpu" / sub /
                      "__init__.py").read_text())
    for node in tree.body:
        if (isinstance(node, ast.Assign)
                and any(getattr(t, "id", None) == "__all__"
                        for t in node.targets)):
            return ast.literal_eval(node.value)
    raise AssertionError(f"no __all__ in pydsproutines_tpu/{sub}")


PORTED = ["ops", "utils", "io", "viz", "models", "signal", "estimation",
          "parallel"]
# subpackages of the JAX package not ported yet (none is left); porting one
# takes it off this list
TO_PORT = set()


@pytest.mark.parametrize("sub", PORTED)
def test_port_exports_every_public_name(sub):
    module = importlib.import_module(f"pydsproutines_tpu_torch.{sub}")
    names = _jax_all(sub)
    assert names
    assert [n for n in names if not hasattr(module, n)] == []
    assert set(names) <= set(module.__all__)


def test_only_parallel_is_left_to_port():
    """Every JAX subpackage the port lacks is on the ``TO_PORT`` list."""
    subs = {p.name for p in (PKG.parent / "pydsproutines_tpu").iterdir()
            if (p / "__init__.py").exists()}
    missing = {s for s in subs if not (PKG / s / "__init__.py").exists()}
    assert set(PORTED) <= subs - missing
    assert missing <= TO_PORT


def _public_surface(path: Path) -> dict[str, list[str]]:
    """Public top-level ``def``s and ``class``es of a module, read by ast,
    each class with its public methods and ``__call__``."""
    surface = {}
    for node in ast.parse(path.read_text()).body:
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)) or node.name.startswith("_"):
            continue
        surface[node.name] = [
            m.name for m in getattr(node, "body", [])
            if isinstance(node, ast.ClassDef)
            and isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))
            and (not m.name.startswith("_") or m.name == "__call__")]
    return surface


JAX_PKG = PKG.parent / "pydsproutines_tpu"
JAX_MODULES = sorted(
    str(p.relative_to(JAX_PKG)) for p in JAX_PKG.rglob("*.py")
    if p.relative_to(JAX_PKG).parts[:2] != ("ops", "pallas"))
# public names of the JAX package with no counterpart in the port (none)
NOT_PORTED: set[str] = set()


@pytest.mark.parametrize("rel", JAX_MODULES)
def test_port_has_every_public_def_class_and_method(rel):
    """Every public top-level def and class of each JAX module outside
    ``ops/pallas/``, and every public method (and ``__call__``) of each
    such class, is an attribute of the port's module at the same path,
    defined there or imported."""
    surface = _public_surface(JAX_PKG / rel)
    parts = Path(rel).with_suffix("").parts
    if parts[-1] == "__init__":
        parts = parts[:-1]
    module = importlib.import_module(".".join(("pydsproutines_tpu_torch",
                                               *parts)))
    missing = []
    for name, methods in surface.items():
        obj = getattr(module, name, None)
        if obj is None:
            missing.append(f"{rel}:{name}")
            continue
        missing += [f"{rel}:{name}.{m}" for m in methods
                    if not hasattr(obj, m)]
    assert set(missing) == {m for m in NOT_PORTED if m.startswith(rel)}


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


def test_transform_entry_points_without_cuda_raise():
    """The WOLA plane instance and ``call_peak``'s kernel raise when there
    is no GPU and refuse other devices; neither hands the work to a plain
    twin."""
    from pydsproutines_tpu_torch.ops.fft import FourStepFFT
    if torch.cuda.is_available():
        pytest.skip("CUDA present: this checks the CPU-only behaviour")
    re, h = torch.zeros(64 * 8), torch.ones(128)
    counters = (wola_fused.wola_fused_planes, fft_peak.stage2_peak)
    before = [c.launches for c in counters]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        wola_fused._wola_fused_planes_cuda(h, re, re, 64)
    meta = torch.zeros(64 * 8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        wola_fused.wola_fused_planes(h.to("meta"), meta, meta, 64)
    with pytest.raises(ValueError, match="unsupported device"):
        FourStepFFT(4096).call_peak(torch.zeros(4096, dtype=torch.complex64,
                                                device="meta"))
    assert [c.launches for c in counters] == before


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
    for route in (None, "ols", "direct"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            sliding._sliding_cuda(x, torch.ones((2, 16), dtype=x.dtype),
                                  route)
    assert [c.launches for c in counters] == before


@pytest.mark.parametrize("n,t,length,dtype,device,path", [
    (4_194_304, 4, 1024, torch.complex64, "cuda", "sliding-ols-hopper"),
    (4_194_304, 4, 1024, torch.complex128, "cuda", "sliding-ols-hopper"),
    (4_194_304, 4, 1, torch.complex64, "cuda", "sliding-direct-hopper"),
    (4_194_304, 4, 1024, torch.complex64, "cpu", "plain"),
])
def test_sliding_router(n, t, length, dtype, device, path):
    from pydsproutines_tpu_torch import ops
    got, reason = ops.select_sliding_path(n, t, length, dtype, device)
    assert got == path, reason
    if device == "cuda":
        assert "complex64" in reason and "f32 operations" in reason
    with pytest.raises(ValueError, match="unsupported device"):
        ops.select_sliding_path(n, t, length, dtype, "meta")


def _constructors(device=None):
    """Every class of the port that holds tensors, built on ``device``."""
    import numpy as np
    from pydsproutines_tpu_torch import ops
    from pydsproutines_tpu_torch.models import WidebandReceiver
    from pydsproutines_tpu_torch.ops.xcorr import GenXcorr
    y = np.ones(64, np.complex64)
    trellis = (np.array([1, -1]), np.array([[0, 1], [0, 1]]),
               np.ones((1, 8)), np.zeros(1), 8)
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
        "SimpleDemodulatorPSK": lambda: ops.SimpleDemodulatorPSK(
            8, device=device),
        "SimpleDemodulatorBPSK": lambda: ops.SimpleDemodulatorBPSK(
            device=device),
        "SimpleDemodulatorQPSK": lambda: ops.SimpleDemodulatorQPSK(
            device=device),
        "SimpleDemodulator8PSK": lambda: ops.SimpleDemodulator8PSK(
            device=device),
        "SimpleDemodulatorPSK.from_numpy_params":
            lambda: ops.SimpleDemodulatorPSK.from_numpy_params(
                {"m": 4, "bitmap": np.arange(4)}, device=device),
        "DemodulatorBatchPSK": lambda: ops.DemodulatorBatchPSK(
            2, "bpsk", device=device),
        "DemodulatorBatchQPSK": lambda: ops.DemodulatorBatchQPSK(
            device=device),
        "DemodulatorBatchQPSK.from_numpy_params":
            lambda: ops.DemodulatorBatchQPSK.from_numpy_params(
                {"bitmap": np.arange(4)}, device=device),
        "ViterbiDemodulator": lambda: ops.ViterbiDemodulator(
            *trellis, device=device),
        "ViterbiDemodulator.from_numpy_params":
            lambda: ops.ViterbiDemodulator.from_numpy_params(
                dict(zip(("alphabet", "pretransitions", "pulses", "omegas",
                          "up"), trellis), allowed_start_idx=[0, 1],
                     survivor_metric="path"), device=device),
        "BurstyViterbiDemodulator": lambda: ops.BurstyViterbiDemodulator(
            *trellis, 10, 3, device=device),
        "BurstyViterbiDemodulator.from_numpy_params":
            lambda: ops.BurstyViterbiDemodulator.from_numpy_params(
                dict(zip(("alphabet", "pretransitions", "pulses", "omegas",
                          "up"), trellis), allowed_start_idx=[0, 1],
                     num_burst_syms=10, num_guard_syms=3), device=device),
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

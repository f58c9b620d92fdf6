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
from pydsproutines_tpu_torch.ops.hopper import _build, fused_xcorr, wola_fused
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
    (1024, None, "plain"),               # non-uniform shifts
])
def test_xcorr_router_on_cuda(n, step, path):
    got, reason = select_xcorr_path(n, torch.complex64, step, "cuda")
    assert got == path, reason
    if path == "fused-hopper" and n < 4096:
        assert "gate does not apply" in reason


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
    before = (wola_fused.wola_fused.launches, fused_xcorr.caf_peak.launches)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        wola_fused._wola_fused_cuda(h, x, 64)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fused_xcorr._caf_peak_cuda(x, x[:64].clone(), 0, 1, 4, 4)
    with pytest.raises(RuntimeError):
        _build.library()
    assert (wola_fused.wola_fused.launches,
            fused_xcorr.caf_peak.launches) == before


def test_wrappers_refuse_other_devices():
    x = torch.zeros(64 * 8, dtype=torch.complex64, device="meta")
    h = torch.ones(128, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        wola_fused.wola_fused(h, x, 64)
    with pytest.raises(ValueError, match="unsupported device"):
        fused_xcorr.caf_peak(x, x[:64], 0, 1, 4, 4)


def test_build_sources_are_the_package_csrc():
    names = [p.name for p in _build.sources()]
    assert names == ["fused_xcorr.cu", "wola_fused.cu"]
    for src in _build.sources():
        text = src.read_text()
        assert "torch/extension.h" not in text
        assert "cufft" not in text.lower() and "cublas" not in text.lower()

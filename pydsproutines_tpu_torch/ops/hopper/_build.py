"""Build and load the hand-written Hopper kernels.

Every ``csrc/*.cu`` source of the package is compiled by ``nvcc`` for
``sm_90a`` (one nvcc per source, all at once) and linked into one shared
library with a plain C interface, at first use,
into ``pydsproutines_tpu_torch/_build/`` (git-ignored). The library's name
carries a hash of the sources, the shared ``csrc/*.cuh`` headers and the
flags, so an edited source or header is rebuilt and a stale library is never
loaded. It is bound with ``ctypes``; nothing here
includes PyTorch's headers, which keeps a cold build to seconds.

Nothing is built or loaded on import: a CPU-only process imports the package
freely and only a launch on a CUDA tensor reaches :func:`library`.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# C signature of every entry point: (argtypes, restype)
_SIGNATURES = {
    "pdsp_wola_fused": ([_P] * 5 + [_L, _I, _I, _P] + [_I] * 3 + [_P], _I),
    "pdsp_wola_fused_planes": ([_P] * 7 + [_L, _I, _I, _P] + [_I] * 3 + [_P],
                               _I),
    "pdsp_wola_direct": ([_P] * 4 + [_I] * 3 + [_P], _I),
    "pdsp_caf_peak": ([_P] * 9 + [_L, _I, _I, _P], _I),
    "pdsp_stage2_peak": ([_P] * 9 + [_I, _I, _P, _I, _P], _I),
    "pdsp_window_cols": ([_P] * 7 + [_I, _P], _I),
    "pdsp_caf3_peak": ([_P] * 10 + [_I, _P], _I),
    "pdsp_upfirdn_f32": ([_P] * 4 + [_I] * 2 + [_L] * 6 + [_P] + [_I] * 9
                         + [_P], _I),
    "pdsp_upfirdn_f64": ([_P] * 4 + [_I] * 2 + [_L] * 6 + [_P] + [_I] * 9
                         + [_P], _I),
    "pdsp_upfirdn_v1_f32": ([_P] * 4 + [_I] * 2 + [_L] * 6 + [_P]
                            + [_I] * 3 + [_P], _I),
    "pdsp_medfilt_f32": ([_P, _P, _L, _I, _I, _P], _I),
    "pdsp_medfilt_f64": ([_P, _P, _L, _I, _I, _P], _I),
    "pdsp_group_caf": ([_P, _L, _P, _I, _P, _I, _I, _P, _I, _I, _P, _L, _P,
                        _P, _P], _I),
    "pdsp_sliding": ([_P, _L, _P, _I, _I, _P, _P, _P, _P, _P, _P,
                      ctypes.c_float, _P, _P, _P], _I),
}


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def headers() -> list[Path]:
    return sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found on PATH or in /usr/local/cuda/bin; "
                       "the Hopper kernels cannot be built")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources() + headers():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


class BuildInfo:
    """What the last :func:`library` call did: the library path, whether it
    compiled (or found an up-to-date build), the seconds it took and the
    compiler's output (``-Xptxas -v``: registers and shared memory per
    kernel)."""
    path: Path | None = None
    compiled: bool = False
    seconds: float = 0.0
    log: str = ""


build_info = BuildInfo()


def _run_all(cmds: list[list[str]]) -> list[subprocess.CompletedProcess]:
    """Run the commands at once; wait for all of them."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    return [subprocess.CompletedProcess(c, p.returncode, o)
            for c, p, o in zip(cmds, procs, outs)]


def _compile(out: Path) -> None:
    """One nvcc per source, all started together, then one link."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    objdir = Path(tempfile.mkdtemp(dir=BUILD_DIR))
    flags = [f for f in NVCC_FLAGS if f != "-shared"]
    objs = [objdir / (src.stem + ".o") for src in sources()]
    steps = [[_nvcc(), *flags, "-c", "-o", str(o), str(src)]
             for src, o in zip(sources(), objs)]
    t0 = time.perf_counter()
    try:
        results = _run_all(steps)
        if all(r.returncode == 0 for r in results):
            results += _run_all([[_nvcc(), *NVCC_FLAGS, "-o", tmp,
                                  *map(str, objs)]])
    finally:
        shutil.rmtree(objdir, ignore_errors=True)
    build_info.seconds = time.perf_counter() - t0
    build_info.log = "".join(r.stdout for r in results)
    failed = [r for r in results if r.returncode != 0]
    if failed:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({failed[0].returncode}):\n"
                           f"{' '.join(failed[0].args)}\n{build_info.log}")
    os.replace(tmp, out)                     # atomic: concurrent builds race safely
    build_info.compiled = True


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if its sources changed.
    Raises RuntimeError when CUDA is unavailable or the build fails."""
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: the Hopper kernels need an "
                           "NVIDIA GPU (CPU tensors take the plain twins)")
    out = BUILD_DIR / f"libpdsp_hopper_{_digest()}.so"
    if not out.exists():
        _compile(out)
    build_info.path = out
    lib = ctypes.CDLL(str(out))
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def check(rc: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")

"""Dtype policy: complex64/float32 is the working type on the card;
complex128/float64 serve CPU parity checks."""

import contextlib

import numpy as np
import torch

COMPLEX_DTYPE = torch.complex64
FLOAT_DTYPE = torch.float32


@contextlib.contextmanager
def full_f32():
    """Full-f32 matrix products and cuDNN convolutions inside the block,
    whatever the global flags say: cuDNN convolutions default to TF32
    (~1e-3 relative), which the JAX package's Precision.HIGHEST filters do
    not allow. The flags are restored on exit."""
    mm = torch.backends.cuda.matmul.allow_tf32
    cd = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = cd


_REAL_OF = {
    torch.complex64: torch.float32,
    torch.complex128: torch.float64,
    torch.float32: torch.float32,
    torch.float64: torch.float64,
}


_COMPLEX_OF = {
    torch.float32: torch.complex64,
    torch.float64: torch.complex128,
    torch.complex64: torch.complex64,
    torch.complex128: torch.complex128,
}


def real_dtype_for(dtype: torch.dtype) -> torch.dtype:
    """Return the matching real dtype for a complex (or real) dtype."""
    return _REAL_OF[dtype]


def complex_dtype_for(dtype: torch.dtype) -> torch.dtype:
    """Return the matching complex dtype for a real (or complex) dtype."""
    return _COMPLEX_OF[dtype]


def numpy_dtype(dtype: torch.dtype) -> np.dtype:
    """The numpy dtype of a torch dtype (complex64 -> np.complex64, ...),
    for plan constants built on the host."""
    return torch.empty(0, dtype=dtype).numpy().dtype


def to_tensor(a, device=None) -> torch.Tensor:
    """A tensor on ``device`` from a tensor or an array-like (numpy, or a
    JAX array through numpy); read-only arrays are copied first."""
    if isinstance(a, torch.Tensor):
        return a.to(device)
    a = np.asarray(a)
    if not a.flags.writeable:
        a = a.copy()
    return torch.from_numpy(a).to(device)

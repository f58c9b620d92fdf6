"""Dtype policy: complex64/float32 is the working type on the card;
complex128/float64 serve CPU parity checks."""

import torch

FLOAT_DTYPE = torch.float32

_REAL_OF = {
    torch.complex64: torch.float32,
    torch.complex128: torch.float64,
    torch.float32: torch.float32,
    torch.float64: torch.float64,
}


def real_dtype_for(dtype: torch.dtype) -> torch.dtype:
    """Return the matching real dtype for a complex (or real) dtype."""
    return _REAL_OF[dtype]

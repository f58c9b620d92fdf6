"""Masked batch row operations.

PyTorch counterpart of ``pydsproutines_tpu/ops/masked.py`` (reference
custom_kernels/maskedaccess.cu: multiplyOnlyMaskedRows :20,
multiplyRowsBasedOnMask :49). Plain torch on the device of the inputs: the
predicated form is one dense elementwise operation, and no TPU kernel lies
on this path. Each function follows the device of its tensor ``x``; an
array ``x`` goes to ``device`` (the card when None), and the other inputs
follow ``x``.
"""

from __future__ import annotations

import torch

from pydsproutines_tpu_torch.utils.device import place
from pydsproutines_tpu_torch.utils.dtypes import to_tensor


def _inputs(x, others, device):
    """``x`` placed by ``place``; the other arrays follow it."""
    x = place(x, device)
    return (x, *(to_tensor(a, x.device) for a in others))


def multiply_only_masked_rows(mask, x, y, mask_value_used=1,
                              device=None) -> torch.Tensor:
    """out[i] = x[i] * y[i] where mask[i] == mask_value_used, else x[i]
    passes through unchanged. mask: (M,), x/y: (M, N)."""
    x, mask, y = _inputs(x, (mask, y), device)
    sel = (mask == mask_value_used)[:, None]
    return torch.where(sel, x * y, x)


def multiply_rows_based_on_mask(mask, x, y0, y1,
                                device=None) -> torch.Tensor:
    """out[i] = x[i] * (y1[i] if mask[i] else y0[i])
    (reference multiplyRowsBasedOnMask, maskedaccess.cu:49)."""
    x, mask, y0, y1 = _inputs(x, (mask, y0, y1), device)
    sel = (mask != 0)[:, None]
    return x * torch.where(sel, y1, y0)


def multiply_masked_rows_gathered(mask, x, y, capacity: int | None = None,
                                  mask_value_used=1, device=None):
    """Compacting variant: gather the selected rows to the front, in row
    order, into a fixed ``capacity`` and multiply only those.

    Returns (rows (capacity, N), int32 count of selected rows). Rows past the
    count are 0. The order is a stable sort of ~sel (JAX's ``jnp.argsort``
    is stable; torch's default argsort is not)."""
    x, mask, y = _inputs(x, (mask, y), device)
    m = x.shape[0]
    cap = capacity if capacity is not None else m
    sel = mask == mask_value_used
    order = torch.argsort((~sel).to(torch.int8), stable=True)
    idx = order[:cap]
    rows = x[idx] * y[idx]
    valid = sel[idx]
    out = torch.where(valid[:, None], rows, torch.zeros((), dtype=rows.dtype,
                                                        device=rows.device))
    return out, sel.sum().to(torch.int32)

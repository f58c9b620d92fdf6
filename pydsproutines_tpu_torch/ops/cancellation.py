"""Signal cancellation: LS complex-amplitude estimate and subtraction.

PyTorch counterpart of ``pydsproutines_tpu/ops/cancellation.py`` (reference
cancellationRoutines.py:12, cancelSignalAtIdx). Plain torch on the device of
``rx``; no TPU kernel lies on this path.
"""

from __future__ import annotations

import torch

from pydsproutines_tpu_torch.utils.device import place
from pydsproutines_tpu_torch.utils.dtypes import to_tensor


def cancel_signal_at_idx(sig, rx, idx: int, device=None):
    """Estimate the complex amplitude of ``sig`` inside ``rx`` at ``idx`` by
    least squares and subtract it (reference cancelSignalAtIdx).

    The window start is clamped to [0, len(rx) - len(sig)], as the JAX
    package's ``dynamic_slice`` / ``dynamic_update_slice`` clamp it, so a
    late ``idx`` cancels the last full window. The amplitude is
    vdot(sig, seg) / ||sig||^2.

    ``rx`` as a tensor stays on its device; as an array it goes to
    ``device`` (the card when None). ``sig`` follows ``rx``.

    Returns (cancelled copy of rx, estimated amplitude as a 0-d tensor)."""
    rx = place(rx, device)
    sig = to_tensor(sig, rx.device)
    siglen = sig.shape[-1]
    start = max(0, min(int(idx), rx.shape[-1] - siglen))
    seg = rx[start: start + siglen]
    pdt = torch.sum(sig.conj() * seg)
    amp = pdt / torch.sum(sig.real * sig.real + sig.imag * sig.imag)
    cancelled = rx.clone()
    cancelled[start: start + siglen] = seg - amp * sig
    return cancelled, amp

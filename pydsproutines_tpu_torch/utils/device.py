"""Where the port's objects live: on the card unless the caller says
otherwise.

Every class of the port that holds tensors (plans, streaming state, models)
takes its device through :func:`resolve_device`. With no device it targets
``cuda`` and raises where there is none: a CPU run is asked for by name
(``device="cpu"``), never fallen into. Plain functions on tensors follow
their inputs' device and do not come here.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``torch.device(device)``; ``cuda`` when ``device`` is None, which
    raises RuntimeError on a machine without CUDA. A CUDA device gets its
    index (``cuda`` -> ``cuda:0``), so a plan's device compares equal to
    the device of the tensors placed on it."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no device was given and CUDA is not "
                               "available: pass device='cpu' to run on the "
                               "CPU")
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device

"""pydsproutines_tpu_torch: the PyTorch / CUDA port of pydsproutines_tpu.

The receiver's main path (WOLA channelizer -> strongest channel ->
frequency-scanning CAF peak search -> PSK demod), the burst-detection and
resampling front end (FIR/upfirdn, median filter, threshold edges) and the
big-window CAF searches, the demodulation layer, and the TDOA/FDOA
geolocation path (scene synthesis, the checkpointed CAF pipeline, grid
localization), the analysis operators (MUSIC, cyclostationary estimates,
matrix profile, cancellation, masked rows, min-max scaling), the capture
readers and INI config (``io``) and the matplotlib viewers (``viz``,
matplotlib imported only when a plot draws) in PyTorch, with the TPU kernels
they reach rewritten by hand for NVIDIA Hopper (CUDA C++ in ``csrc/``, built
with nvcc at first use on a CUDA tensor). CPU tensors take each kernel's
plain PyTorch twin. The package never imports JAX.
"""

from pydsproutines_tpu_torch import (estimation, io, models, ops, signal,
                                     utils, viz)
from pydsproutines_tpu_torch.models import (CheckpointedXcorrPipeline,
                                            WidebandReceiver)
from pydsproutines_tpu_torch.ops import (Channeliser, fast_xcorr,
                                         select_wola_path, select_xcorr_path,
                                         wola)

__all__ = ["estimation", "io", "models", "ops", "signal", "utils", "viz",
           "WidebandReceiver", "CheckpointedXcorrPipeline", "Channeliser",
           "fast_xcorr", "select_wola_path", "select_xcorr_path", "wola"]

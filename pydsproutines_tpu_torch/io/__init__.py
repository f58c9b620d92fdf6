"""I/O and persistence: the xcorr results database (a copy of the JAX
package's host-only ``io/xcorrdb.py``). The capture readers (``binfiles``)
and the INI config system (``config``) are not ported yet."""

from pydsproutines_tpu_torch.io.xcorrdb import XcorrDB

__all__ = ["XcorrDB"]

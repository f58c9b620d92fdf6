"""I/O, persistence and config layer: binary capture readers with native
threaded loading and prefetch, the streaming capture loader, the xcorr
results and group databases, and the INI config system. Copies of the JAX
package's host-only ``io/`` modules; frames come back as host numpy."""

from pydsproutines_tpu_torch.io.binfiles import (FolderReader, GroupDatabase,
                                                 GroupReader,
                                                 SortedFolderReader,
                                                 StreamingCaptureLoader,
                                                 is_int16_clipping,
                                                 multi_bin_read,
                                                 simple_bin_read)
from pydsproutines_tpu_torch.io.config import (DSPConfig, ProcessingSection,
                                               SignalSection, SourceSection,
                                               WorkspaceSection)
from pydsproutines_tpu_torch.io.xcorrdb import XcorrDB

__all__ = ["simple_bin_read", "multi_bin_read", "is_int16_clipping",
           "FolderReader", "SortedFolderReader", "GroupReader",
           "GroupDatabase", "StreamingCaptureLoader", "XcorrDB", "DSPConfig",
           "SourceSection", "SignalSection", "ProcessingSection",
           "WorkspaceSection"]

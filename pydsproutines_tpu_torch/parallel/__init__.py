"""Distribution layer: named meshes, shift-sharded CAF search, time-sharded
streaming filters and channelizer with halo exchange, and the multi-host
runtime (the counterpart of ``pydsproutines_tpu/parallel``).

The JAX layer is one program over a device ``Mesh`` with ``shard_map`` and
collectives. Here it is SPMD on ``torch.distributed``: one process a
device, every rank calling each sharded function with the same arguments.
Inputs are whole (each rank takes its block) or DTensors sharded
``Shard(0)`` on the mesh dimension (``multihost.shard_local_blocks``);
sharded outputs come back as DTensors, ``Shard(0)`` on that dimension
(``.to_local()`` is the rank's block, ``.full_tensor()`` the whole); peak
reductions return the same Python scalars on every rank. Each rank's
compute is the single-device op, so on the card it runs the same Hopper
kernels: WOLA (#1), the CAF peak (#2, #4 for listed shifts), upfirdn (#5)
and the group CAF (#8). What crosses ranks (halos, peak scalars) is in
``_exchange``; ``dryrun`` runs the layer's parity checks on a spawned
group and ``multihost_pipeline`` is the torchrun walkthrough.
"""

from pydsproutines_tpu_torch.parallel import multihost
from pydsproutines_tpu_torch.parallel.filters import sharded_lfilter
from pydsproutines_tpu_torch.parallel.groupxcorr import (
    sharded_group_xcorr_czt, sharded_group_xcorr_fft,
    sharded_group_xcorr_peak)
from pydsproutines_tpu_torch.parallel.mesh import default_mesh, make_mesh
from pydsproutines_tpu_torch.parallel.wola import (sharded_multichannel_wola,
                                                   sharded_wola)
from pydsproutines_tpu_torch.parallel.xcorr import (sharded_caf_peak,
                                                    sharded_fast_xcorr)

__all__ = [
    "make_mesh",
    "default_mesh",
    "sharded_fast_xcorr",
    "sharded_caf_peak",
    "sharded_lfilter",
    "sharded_wola",
    "sharded_multichannel_wola",
    "sharded_group_xcorr_czt",
    "sharded_group_xcorr_fft",
    "sharded_group_xcorr_peak",
    "multihost",
]

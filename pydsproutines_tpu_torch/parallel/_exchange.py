"""What crosses ranks in the distribution layer, and how.

The JAX layer runs one program over a mesh and moves data with ``ppermute``
(the halo) and ``all_gather`` (peak scalars). Here every rank runs the same
function on its own block, and these helpers are the only places where
data crosses ranks:

* ``halo_from_left``: rank d's last samples go to rank d + 1; rank 0 gets
  zeros (the JAX ``jnp.where(i == 0, 0, halo)``).
* ``gather_scalars``: every rank's (peak, shift, bin) triple is gathered and
  the largest peak taken, ties to the lowest rank (``jnp.argmax``).
* ``gather_blocks``: a DTensor's blocks, gathered whole (the shift lists of
  a sweep, a few thousand integers).

How a tensor crosses is fixed by the group's backend and the tensor's
device before anything is sent (``transport``): NCCL carries CUDA tensors;
gloo carries CPU tensors, and a CUDA tensor through host memory, because
gloo's point-to-point and gather operations take CPU tensors only. Only
halos, scalars and shift lists take that road; compute stays on the card.

The rest is the bookkeeping of blocks: a rank's block of a replicated
tensor or of a DTensor sharded ``Shard(0)`` on one mesh dimension
(``local_block``, ``shift_block``), and the DTensor that a sharded result
becomes (``sharded``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Shard

from pydsproutines_tpu_torch.utils.dtypes import to_tensor

NCCL, GLOO, GLOO_HOST = "nccl", "gloo", "gloo via host memory"


def transport(group, device: torch.device) -> str:
    """How a tensor on ``device`` crosses ``group``: ``"nccl"``, ``"gloo"``
    or ``"gloo via host memory"``; raises for a pair that cannot carry it
    (an NCCL group and a CPU tensor)."""
    backend = str(dist.get_backend(group))
    if device.type == "cuda" and "nccl" in backend:
        return NCCL
    if "gloo" in backend:
        return GLOO_HOST if device.type == "cuda" else GLOO
    raise ValueError(f"a {backend} process group cannot carry "
                     f"{device.type} tensors")


def _wire(t: torch.Tensor, how: str) -> torch.Tensor:
    """``t`` as it goes on the wire: real (complex as its (re, im) pairs),
    contiguous, in host memory when gloo carries a CUDA tensor."""
    t = torch.view_as_real(t) if t.is_complex() else t
    return (t.cpu() if how == GLOO_HOST else t).contiguous()


def _unwire(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    t = t.to(like.device)
    return torch.view_as_complex(t) if like.is_complex() else t


def halo_from_left(tail: torch.Tensor, group) -> torch.Tensor:
    """Send ``tail`` to the next rank of ``group`` and return the previous
    rank's (zeros on rank 0): the ``ppermute`` d -> d + 1 of the JAX
    ``sharded_lfilter`` / ``sharded_wola``."""
    rank, size = dist.get_rank(group), dist.get_world_size(group)
    if size == 1:
        return torch.zeros_like(tail)
    send = _wire(tail, transport(group, tail.device))
    recv = torch.empty_like(send)
    ops = []
    if rank + 1 < size:
        ops.append(dist.P2POp(dist.isend, send, group=group,
                              group_peer=rank + 1))
    if rank > 0:
        ops.append(dist.P2POp(dist.irecv, recv, group=group,
                              group_peer=rank - 1))
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    if rank == 0:
        return torch.zeros_like(tail)
    return _unwire(recv, tail)


def gather_scalars(peak: torch.Tensor, shift, bin_, group
                   ) -> tuple[float, int, int]:
    """(peak, shift, bin) of the rank whose ``peak`` is largest, the lowest
    such rank on ties; the same plain scalars on every rank. Only the three
    scalars of each rank cross, in one gather of an int64 row: the peak's
    float64 bits (exact for a float32 peak), the shift and the bin; the
    host waits for the device once."""
    dev = peak.device
    row = torch.stack([
        peak.reshape(()).to(torch.float64).view(torch.int64),
        *(torch.as_tensor(v, dtype=torch.int64, device=dev).reshape(())
          for v in (shift, bin_))])
    send = _wire(row, transport(group, dev))
    rows = [torch.empty_like(send)
            for _ in range(dist.get_world_size(group))]
    dist.all_gather(rows, send, group=group)
    rows = torch.stack(rows).cpu()
    peaks = rows[:, 0].contiguous().view(torch.float64)
    j = int(torch.argmax(peaks))
    return float(peaks[j]), int(rows[j, 1]), int(rows[j, 2])


def gather_blocks(block: torch.Tensor, group) -> torch.Tensor:
    """Every rank's equal-sized ``block`` of ``group``, concatenated, on
    ``block``'s device."""
    send = _wire(block, transport(group, block.device))
    parts = [torch.empty_like(send)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, send, group=group)
    return _unwire(torch.cat(parts), block)


def device_of(mesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def replicated(a, mesh, what: str) -> torch.Tensor:
    """``a``, an input every rank holds whole, as a tensor on the mesh's
    device: an array-like is placed there; a tensor on another kind of
    device raises (nothing is moved quietly)."""
    if isinstance(a, DTensor):
        raise ValueError(f"{what} is replicated: pass a plain tensor")
    if isinstance(a, torch.Tensor):
        if a.device.type != mesh.device_type:
            raise ValueError(f"{what} on {a.device}, the mesh on "
                             f"{mesh.device_type}")
        return a
    return to_tensor(a, device_of(mesh))


def local_block(x, mesh, axis: str) -> torch.Tensor:
    """This rank's block of ``x`` along its first dimension, split over
    ``mesh[axis]``: a DTensor sharded ``Shard(0)`` on ``mesh[axis]`` gives
    its local tensor; a replicated ``x`` (tensor or array-like) is sliced.
    Callers check divisibility first."""
    sub = mesh[axis]
    if isinstance(x, DTensor):
        if x.device_mesh != sub or tuple(x.placements) != (Shard(0),):
            raise ValueError(f"a DTensor input must be sharded Shard(0) on "
                             f"mesh[{axis!r}] (as shard_local_blocks makes "
                             f"it), not {x.placements} on {x.device_mesh}")
        return x.to_local()
    x = replicated(x, mesh, "x")
    block = x.shape[0] // sub.size()
    rank = sub.get_local_rank()
    return x[rank * block: (rank + 1) * block]


def shift_block(shifts, mesh, axis: str) -> tuple[np.ndarray, np.ndarray]:
    """(the whole shift list, this rank's contiguous block of it), as host
    int64 arrays. A DTensor list is gathered whole (its blocks are a few
    thousand integers), so a uniform sweep is recognised over the whole
    list, as the JAX ``_split`` does on the host."""
    sub = mesh[axis]
    if isinstance(shifts, DTensor):
        whole = gather_blocks(local_block(shifts, mesh, axis),
                              sub.get_group())
    else:
        whole = shifts
    if isinstance(whole, torch.Tensor):
        whole = whole.cpu().numpy()
    whole = np.asarray(whole)
    ndev = sub.size()
    per = whole.shape[0] // ndev
    if per * ndev != whole.shape[0]:
        raise ValueError("len(shifts) must divide evenly over the mesh axis")
    rank = sub.get_local_rank()
    return whole, whole[rank * per: (rank + 1) * per].astype(np.int64)


def sharded(local: torch.Tensor, mesh, axis: str) -> DTensor:
    """This rank's block of a result as one global DTensor, ``Shard(0)`` on
    ``mesh[axis]``: ``.to_local()`` is the block, ``.full_tensor()`` the
    whole result."""
    return DTensor.from_local(local, mesh[axis], [Shard(0)], run_check=False)

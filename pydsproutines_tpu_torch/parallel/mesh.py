"""Device meshes (the counterpart of ``pydsproutines_tpu/parallel/mesh.py``).

A mesh is a ``torch.distributed`` ``DeviceMesh`` over the ranks of the
process group, one rank a device. Where no group exists and no launcher
asked for one (``multihost.init_distributed`` finds no cluster in the
arguments or the environment), a single-rank group is started on an
in-memory store, so a caller on one device needs no launcher, as in JAX.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

# the backend a device type's group starts with
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def check_device_type(device_type: str) -> None:
    """Raise unless ``device_type`` is one this layer runs on and the
    machine has it: a ``cuda`` mesh never carries on quietly on the CPU."""
    if device_type not in BACKENDS:
        raise ValueError(f"device_type {device_type!r}: 'cuda' or 'cpu'")
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device_type='cuda' but CUDA is not available: "
                           "pass device_type='cpu' to run on the CPU")


def ensure_group(device_type: str = "cuda") -> None:
    """Start the default process group if there is none: the launch that
    the arguments' environment describes (``multihost.init_distributed``),
    else a single rank on an in-memory store with ``device_type``'s
    backend."""
    check_device_type(device_type)
    if dist.is_initialized():
        return
    from pydsproutines_tpu_torch.parallel.multihost import init_distributed
    init_distributed(device_type=device_type)
    if not dist.is_initialized():
        dist.init_process_group(BACKENDS[device_type], store=dist.HashStore(),
                                rank=0, world_size=1)


def make_mesh(shape: tuple[int, ...] | None = None,
              axis_names: tuple[str, ...] = ("dsp",),
              device_type: str = "cuda") -> DeviceMesh:
    """A named mesh over the ranks of the process group.

    Default: one axis named "dsp" spanning every rank, the axis the parallel
    ops shard shifts and time over. Every rank of the group is in the mesh
    (each calls the sharded functions), so ``shape`` must cover the world
    exactly; a shape that needs more ranks than the world has raises
    ValueError, as the JAX mesh does for devices.
    """
    ensure_group(device_type)
    world = dist.get_world_size()
    if shape is None:
        shape = (world,)
    n = math.prod(shape)
    if n > world:
        raise ValueError(f"mesh shape {shape} needs {n} devices, "
                         f"have {world}")
    if n < world:
        raise ValueError(f"mesh shape {shape} covers {n} of the {world} "
                         f"ranks: every rank must be in the mesh")
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axis_names))


def default_mesh() -> DeviceMesh:
    return make_mesh()

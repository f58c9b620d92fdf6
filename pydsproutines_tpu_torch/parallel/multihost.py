"""Multi-host distribution: process-sharded input, host x chip meshes,
heartbeat failure detection and elastic restart from a checkpoint (the
counterpart of ``pydsproutines_tpu/parallel/multihost.py``).

The torch form of the multi-controller recipe:

  * every process runs the same program, one process a device;
    ``init_distributed`` joins them into one process group
    (``torch.distributed``: NCCL between cards, gloo for CPU tensors), from
    its arguments or torchrun's environment,
  * each process loads only its own time range of the capture
    (``process_shard_bounds`` + ``read_local_capture``: interleaved-int16
    files are seekable, so a process reads exactly its block, plus any
    filter halo, from disk and no bulk samples cross the network),
  * the process-local blocks become one global DTensor through
    ``shard_local_blocks``, on which the sharded ops (``sharded_wola``,
    ``sharded_lfilter``, ``sharded_caf_peak``) work unchanged,
  * failures are handled by heartbeat files and results-level
    checkpoints: the XcorrDB rows of ``models.pipeline.
    CheckpointedXcorrPipeline`` mark the blocks done, ``run_elastic``
    retries from the first missing one, and ``Heartbeat`` /
    ``cluster_progress`` let a supervisor spot a wedged worker.

``process_shard_bounds``, ``read_local_capture``, ``Heartbeat``,
``cluster_progress`` and ``run_elastic`` are numpy / Python, copies of the
JAX module's (edit neither side alone).
"""

from __future__ import annotations

import json
import os
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor

from pydsproutines_tpu_torch.io.binfiles import simple_bin_read
from pydsproutines_tpu_torch.parallel._exchange import replicated, sharded
from pydsproutines_tpu_torch.parallel.mesh import (BACKENDS,
                                                   check_device_type,
                                                   ensure_group, make_mesh)


# ---------------------------------------------------------------------------
# Runtime initialization
# ---------------------------------------------------------------------------

def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     local_device_ids=None,
                     device_type: str = "cuda") -> bool:
    """Join the process group of a multi-process launch. Idempotent;
    returns True when running multi-process after the call.

    ``coordinator_address`` is rank 0's ``host:port`` (or an init URL,
    ``tcp://...`` or ``file://...``), ``num_processes`` the world size and
    ``process_id`` this rank; each absent one is read from torchrun's
    ``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK``. With none
    of them given or set, no group is started and False is returned (a
    single process needs none). A launch that is asked for and fails
    raises. ``local_device_ids``: the cards of this process (its first
    becomes the current device; default torchrun's ``LOCAL_RANK``). The
    group's backend is ``device_type``'s: NCCL for ``cuda``, gloo for
    ``cpu``.
    """
    if dist.is_initialized():
        return dist.get_world_size() > 1
    env = os.environ
    if coordinator_address is None and "MASTER_ADDR" in env:
        coordinator_address = (f"{env['MASTER_ADDR']}:"
                               f"{env.get('MASTER_PORT', '29500')}")
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and "RANK" in env:
        process_id = int(env["RANK"])
    if coordinator_address is None and num_processes is None:
        return False
    if None in (coordinator_address, num_processes, process_id):
        raise ValueError(
            f"a launch needs the coordinator's address, the number of "
            f"processes and this process's id; got {coordinator_address!r}, "
            f"{num_processes!r}, {process_id!r}")
    check_device_type(device_type)
    if device_type == "cuda":
        if local_device_ids is None:
            local_device_ids = [int(env.get("LOCAL_RANK", 0))]
        torch.cuda.set_device(int(local_device_ids[0]))
    url = (coordinator_address if "://" in coordinator_address
           else f"tcp://{coordinator_address}")
    dist.init_process_group(BACKENDS[device_type], init_method=url,
                            world_size=int(num_processes),
                            rank=int(process_id))
    return dist.get_world_size() > 1


def host_chip_mesh(axis_names: tuple[str, str] = ("host", "chip"),
                   device_type: str = "cuda"):
    """(num_hosts, chips_per_host) mesh: the ``host`` axis crosses the
    network, the ``chip`` axis stays inside a host (NVLink). Shard bulk time
    blocks over ``host`` and latency-sensitive axes (shifts, channels) over
    ``chip``. Chips a host: torchrun's ``LOCAL_WORLD_SIZE`` (the whole world
    when unset); ranks are numbered host by host, as torchrun does."""
    ensure_group(device_type)
    world = dist.get_world_size()
    per = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if world % per != 0:
        raise ValueError(f"{world} ranks do not split into hosts of {per}")
    return init_device_mesh(device_type, (world // per, per),
                            mesh_dim_names=tuple(axis_names))


def flat_mesh(axis_name: str = "dsp", device_type: str = "cuda"):
    """One mesh axis over every rank of every process: the layout the
    single-host parallel ops use, now spanning hosts."""
    return make_mesh(None, (axis_name,), device_type)


# ---------------------------------------------------------------------------
# Process-sharded input pipeline
# ---------------------------------------------------------------------------

def process_shard_bounds(total_samples: int, num_processes: int,
                         process_id: int, halo: int = 0) -> tuple[int, int]:
    """[start, stop) sample range process ``process_id`` must LOAD so that
    contiguous equal blocks of ``total_samples // num_processes`` samples are
    locally available, plus ``halo`` extra samples of left overlap (the
    filter warm-up / overlap-save halo; process 0 has none).

    total_samples must divide evenly (static shapes everywhere)."""
    if total_samples % num_processes != 0:
        raise ValueError(f"total {total_samples} does not divide over "
                         f"{num_processes} processes")
    block = total_samples // num_processes
    start = process_id * block
    return max(0, start - halo), start + block


def read_local_capture(filename, total_samples: int, num_processes: int,
                       process_id: int, halo: int = 0, in_dtype=np.int16,
                       out_dtype=np.complex64) -> np.ndarray:
    """Read only this process's time range (plus halo) of an interleaved-I/Q
    bin capture, by seeking, so N hosts read the file (or its N shards) in
    parallel without moving bulk data over the network.

    Reference analogue: simpleBinRead (usrpRoutines.py:51), here with a
    byte-offset window per host."""
    start, stop = process_shard_bounds(total_samples, num_processes,
                                       process_id, halo)
    itemsize = np.dtype(in_dtype).itemsize * 2   # interleaved I/Q
    return simple_bin_read(filename, num_samps=stop - start,
                           in_dtype=in_dtype, out_dtype=out_dtype,
                           offset=start * itemsize)


def shard_local_blocks(local_block, mesh, axis: str = "dsp") -> DTensor:
    """One global DTensor from each process's contiguous block (no halo:
    halos are exchanged by the parallel ops): ``Shard(0)`` on
    ``mesh[axis]``, its global length the block's times the axis size; no
    bulk data crosses ranks. A numpy block is placed on the mesh's device; a
    tensor must already lie on that kind of device."""
    return sharded(replicated(local_block, mesh, "local_block"), mesh, axis)


# ---------------------------------------------------------------------------
# Failure detection: heartbeat files + liveness checks
# ---------------------------------------------------------------------------

class Heartbeat:
    """Per-process liveness beacon on a shared filesystem.

    Each process periodically writes ``{dir}/hb_{pid}.json`` with a wall-time
    stamp and a progress payload (e.g. last completed block). Any process —
    or an external supervisor — can call ``stale_processes`` to find workers
    whose beacons have gone quiet and trigger a restart; restarted workers
    resume from the results-level checkpoint (CheckpointedXcorrPipeline
    skips completed blocks)."""

    def __init__(self, directory, process_id: int, interval: float = 5.0):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.process_id = int(process_id)
        self.interval = float(interval)
        self._last = 0.0
        self.path = self.dir / f"hb_{self.process_id}.json"

    def beat(self, progress: dict | None = None, force: bool = False) -> None:
        """Write a beacon if ``interval`` elapsed (cheap to call per block)."""
        now = time.time()
        if not force and now - self._last < self.interval:
            return
        payload = {"process_id": self.process_id, "time": now,
                   "progress": progress or {}}
        tmp = self.path.with_suffix(".tmp")
        tmp.write_text(json.dumps(payload))
        os.replace(tmp, self.path)   # atomic on POSIX
        self._last = now

    def read_all(self) -> dict[int, dict]:
        out = {}
        for p in self.dir.glob("hb_*.json"):
            try:
                d = json.loads(p.read_text())
                out[int(d["process_id"])] = d
            except (ValueError, KeyError, OSError):
                continue   # torn write from a dying process: treat as absent
        return out

    def stale_processes(self, timeout: float, expected: int | None = None
                        ) -> list[int]:
        """Process ids whose beacon is older than ``timeout`` seconds (or
        missing entirely, when ``expected`` gives the full process count)."""
        now = time.time()
        seen = self.read_all()
        stale = [pid for pid, d in seen.items()
                 if now - float(d["time"]) > timeout]
        if expected is not None:
            stale += [pid for pid in range(expected) if pid not in seen]
        return sorted(set(stale))


def cluster_progress(hb_dir, timeout: float = 30.0,
                     expected: int | None = None) -> dict:
    """One queryable snapshot of cluster state from the heartbeat beacons:
    per-process progress payloads + who is stale (the supervisor's view of
    Heartbeat.beat(progress=...))."""
    hb = Heartbeat(hb_dir, process_id=-1)
    now = time.time()
    beacons = hb.read_all()
    procs = {
        pid: {"age_s": round(now - float(d["time"]), 3),
              "progress": d.get("progress", {})}
        for pid, d in beacons.items() if pid >= 0}
    stale = [pid for pid, d in procs.items() if d["age_s"] > timeout]
    if expected is not None:
        stale += [pid for pid in range(expected) if pid not in procs]
    return {"processes": procs, "stale": sorted(set(stale)),
            "alive": sorted(pid for pid in procs if pid not in stale)}


def run_elastic(pipeline, rx, heartbeat: Heartbeat | None = None,
                max_restarts: int = 2, progress: bool = False) -> int:
    """Drive a CheckpointedXcorrPipeline to completion with liveness beacons
    and bounded in-process retry.

    Each completed block beats the heartbeat with the block index; a
    transient failure (device error, preempted host) retries from the DB
    checkpoint — completed blocks are never recomputed. Returns the total
    number of blocks computed across attempts."""
    total = 0
    attempts = 0
    while True:
        try:
            if heartbeat is not None:
                done = pipeline.completed_blocks()
                heartbeat.beat({"completed_blocks": len(done)}, force=True)
            total += pipeline.run(rx, progress=progress)
            if heartbeat is not None:
                heartbeat.beat({"done": True}, force=True)
            return total
        except KeyboardInterrupt:
            raise
        except Exception as e:
            attempts += 1
            metrics = getattr(pipeline, "metrics", None)
            if metrics is not None:
                metrics.emit("elastic.restart", attempts,
                             error=type(e).__name__)
            if attempts > max_restarts:
                raise

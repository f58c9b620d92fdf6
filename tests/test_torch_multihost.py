"""The port's multi-host runtime (``pydsproutines_tpu_torch.parallel.
multihost``, ``dryrun``, ``multihost_pipeline``) against the JAX package's
and the assertions of ``tests/test_multihost.py``.

A real 2-rank gloo cluster (spawned processes, a file store) carries the
FIR and WOLA halos and the CAF peak across a process boundary, with the
inputs made global by ``shard_local_blocks``, then runs the
``multihost_pipeline`` walkthrough on both ranks; ``dryrun_multichip(4)``
runs the layer's five parity checks on a 4-rank group and its (2, 2) mesh.
Both groups start together in the module's fixture (their imports take
most of their time). The rest runs in this process.
"""

from __future__ import annotations

import concurrent.futures
import json
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from pydsproutines_tpu.io.binfiles import simple_bin_read as j_bin_read
from pydsproutines_tpu.parallel import multihost as jmh
from pydsproutines_tpu_torch.io.xcorrdb import XcorrDB
from pydsproutines_tpu_torch.models.pipeline import CheckpointedXcorrPipeline
from pydsproutines_tpu_torch.parallel import dryrun, multihost_pipeline
from pydsproutines_tpu_torch.parallel import multihost as tmh


@pytest.fixture(scope="module")
def groups():
    """The 2-rank cluster's results and the 4-rank dry run, started
    together."""
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        cluster = pool.submit(dryrun.dryrun_multiprocess, "cpu", 240.0)
        multichip = pool.submit(dryrun.dryrun_multichip, 4, "cpu", 240.0)
        yield cluster, multichip


def test_two_process_cluster(groups):
    """FIR + WOLA halo exchange and CAF peak reduction across a REAL process
    boundary match the single-process references; both ranks find the
    planted shift 1000 at bin 0 with the same peak (``dryrun.
    check_cluster`` holds ``tests/test_multihost.py``'s assertions)."""
    results = groups[0].result()
    for r in results:
        assert r["err_fir"] < 1e-5
        assert r["err_wola"] < 1e-4
        assert r["route"][0] == "plain"
    assert results[0]["sbest"] == results[1]["sbest"] == 1000
    assert results[0]["fbest"] == results[1]["fbest"] == 0
    assert results[0]["peak"] == results[1]["peak"] > 0.99
    assert [r["pipeline"]["shift"] for r in results] == [0, 0]


def test_dryrun_multichip(groups):
    assert groups[1].result() is None


def test_check_cluster_rejects_a_wrong_peak():
    good = {"rank": 0, "err_fir": 0.0, "err_wola": 0.0, "peak": 1.0,
            "sbest": 1000, "fbest": 0, "ref": [1.0, 1000, 0],
            "pipeline": {"processes": 2, "shift": 0, "bin": 0, "blocks": 8,
                         "filtered": [multihost_pipeline.TOTAL]}}
    dryrun.check_cluster([good, {**good, "rank": 1}])
    with pytest.raises(AssertionError, match="cluster peaks"):
        dryrun.check_cluster([good, {**good, "rank": 1, "sbest": 999}])
    with pytest.raises(AssertionError, match="FIR err"):
        dryrun.check_cluster([good, {**good, "err_fir": 1e-3}])


@pytest.mark.parametrize("total,nproc,pid,halo", [
    (100, 4, 0, 0), (100, 4, 3, 0), (100, 4, 2, 10), (100, 4, 0, 10),
    (4096, 2, 1, 33)])
def test_process_shard_bounds(total, nproc, pid, halo):
    assert (tmh.process_shard_bounds(total, nproc, pid, halo)
            == jmh.process_shard_bounds(total, nproc, pid, halo))


def test_process_shard_bounds_asserts():
    assert tmh.process_shard_bounds(100, 4, 0) == (0, 25)
    assert tmh.process_shard_bounds(100, 4, 3) == (75, 100)
    assert tmh.process_shard_bounds(100, 4, 2, halo=10) == (40, 75)
    assert tmh.process_shard_bounds(100, 4, 0, halo=10) == (0, 25)
    with pytest.raises(ValueError):
        tmh.process_shard_bounds(101, 4, 0)


def test_read_local_capture(tmp_path):
    """Per-host seek-based reads tile the capture exactly (with halo), as
    the JAX reader's do."""
    rng = np.random.default_rng(3)
    raw = rng.integers(-1000, 1000, 2 * 64, dtype=np.int16)
    path = tmp_path / "cap.bin"
    raw.tofile(path)
    full = j_bin_read(path)
    parts = [tmh.read_local_capture(path, 64, 4, i) for i in range(4)]
    np.testing.assert_array_equal(np.concatenate(parts), full)
    withhalo = tmh.read_local_capture(path, 64, 4, 2, halo=5)
    np.testing.assert_array_equal(withhalo, full[32 - 5: 48])
    np.testing.assert_array_equal(
        withhalo, jmh.read_local_capture(path, 64, 4, 2, halo=5))


def test_heartbeat_stale_detection(tmp_path):
    hb0 = tmh.Heartbeat(tmp_path, 0, interval=0.0)
    hb1 = tmh.Heartbeat(tmp_path, 1, interval=0.0)
    hb0.beat({"block": 3}, force=True)
    hb1.beat({"block": 5}, force=True)
    assert hb0.stale_processes(timeout=60.0, expected=2) == []
    assert hb0.stale_processes(timeout=60.0, expected=3) == [2]
    d = json.loads(hb1.path.read_text())
    d["time"] = time.time() - 120.0
    hb1.path.write_text(json.dumps(d))
    assert hb0.stale_processes(timeout=60.0, expected=2) == [1]
    assert hb0.read_all()[0]["progress"]["block"] == 3
    # the JAX reader sees the same beacons the same way
    jhb = jmh.Heartbeat(tmp_path, 0, interval=0.0)
    assert jhb.stale_processes(timeout=60.0, expected=2) == [1]


def test_cluster_progress_matches_jax(tmp_path):
    tmh.Heartbeat(tmp_path, 0, interval=0.0).beat({"block": 2}, force=True)
    tmh.Heartbeat(tmp_path, 2, interval=0.0).beat({"done": True},
                                                  force=True)
    got = tmh.cluster_progress(tmp_path, timeout=30.0, expected=3)
    ref = jmh.cluster_progress(tmp_path, timeout=30.0, expected=3)
    assert got["stale"] == ref["stale"] == [1]
    assert got["alive"] == ref["alive"] == [0, 2]
    assert ({p: d["progress"] for p, d in got["processes"].items()}
            == {p: d["progress"] for p, d in ref["processes"].items()})


def test_run_elastic_resumes_from_checkpoint(tmp_path):
    """A mid-run crash resumes from the DB checkpoint: completed blocks are
    never recomputed, and the final table holds every block (the port's
    CheckpointedXcorrPipeline with the JAX test's injected failure)."""
    rng = np.random.default_rng(11)
    template = (rng.standard_normal(128) + 1j * rng.standard_normal(128)
                ).astype(np.complex64)
    rx = (0.01 * (rng.standard_normal(1152) + 1j * rng.standard_normal(1152))
          ).astype(np.complex64)
    rx[300:428] += template

    db = XcorrDB(str(tmp_path / "x.db"))
    pipe = CheckpointedXcorrPipeline(db, "xc", template, fs=1e6,
                                     block_shifts=256, device="cpu")
    calls = {"n": 0}
    orig_run = pipe.run

    def flaky_run(rx_, progress=False):
        calls["n"] += 1
        if calls["n"] == 1:
            # the first attempt completes only block 0, then dies
            orig_run(rx_[: template.shape[-1] + pipe.block_shifts - 1])
            raise RuntimeError("injected failure")
        return orig_run(rx_, progress=progress)

    pipe.run = flaky_run
    hb = tmh.Heartbeat(tmp_path / "hb", 0, interval=0.0)
    total = tmh.run_elastic(pipe, torch.from_numpy(rx), heartbeat=hb,
                            max_restarts=2)
    nblocks = pipe.num_blocks(len(rx))
    assert nblocks > 1
    assert total == nblocks - 1
    assert pipe.completed_blocks() == set(range(nblocks))
    pipe.run = orig_run
    assert tmh.run_elastic(pipe, torch.from_numpy(rx), heartbeat=hb) == 0
    assert hb.read_all()[0]["progress"] == {"done": True}
    assert pipe.peak()[0] == 300


def test_run_elastic_gives_up_after_max_restarts(tmp_path):
    class Broken:
        def completed_blocks(self):
            return set()

        def run(self, rx, progress=False):
            raise RuntimeError("device lost")

    with pytest.raises(RuntimeError, match="device lost"):
        tmh.run_elastic(Broken(), None, max_restarts=1)


# ---------------------------------------------------------------------------
# the runtime in this process
# ---------------------------------------------------------------------------

@pytest.fixture
def no_launch_env(monkeypatch):
    for key in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
                "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(key, raising=False)
    assert not dist.is_initialized()
    yield monkeypatch
    if dist.is_initialized():
        dist.destroy_process_group()


def test_init_distributed_without_a_launch(no_launch_env):
    """Nothing given or set: no group is started (single-process use needs
    none)."""
    assert tmh.init_distributed(device_type="cpu") is False
    assert not dist.is_initialized()


def test_init_distributed_from_torchrun_env(no_launch_env):
    """torchrun's variables start the group; a second call is a no-op."""
    for key, value in (("MASTER_ADDR", "127.0.0.1"), ("MASTER_PORT", "0"),
                       ("WORLD_SIZE", "1"), ("RANK", "0")):
        no_launch_env.setenv(key, value)
    assert tmh.init_distributed(device_type="cpu") is False   # world 1
    assert dist.is_initialized() and dist.get_world_size() == 1
    assert dist.get_backend() == "gloo"
    assert tmh.init_distributed(device_type="cpu") is False
    mesh = tmh.flat_mesh("dsp", "cpu")
    assert mesh.mesh_dim_names == ("dsp",) and mesh.size() == 1
    hc = tmh.host_chip_mesh(device_type="cpu")
    assert hc.mesh_dim_names == ("host", "chip") and tuple(hc.shape) == (1, 1)


def test_init_distributed_incomplete_launch_raises(no_launch_env):
    with pytest.raises(ValueError, match="this process's id"):
        tmh.init_distributed("127.0.0.1:0", 2, device_type="cpu")
    no_launch_env.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="coordinator's address"):
        tmh.init_distributed(device_type="cpu")
    assert not dist.is_initialized()


def test_init_distributed_cuda_without_cuda_raises(no_launch_env):
    if torch.cuda.is_available():
        pytest.skip("CUDA present: this checks the CPU-only behaviour")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmh.init_distributed("127.0.0.1:0", 1, 0)
    assert not dist.is_initialized()


def test_shard_local_blocks_world_one(no_launch_env):
    """A numpy block lands on the mesh's device as a Shard(0) DTensor; a
    tensor on another kind of device raises."""
    mesh = tmh.flat_mesh("dsp", "cpu")
    block = np.arange(12, dtype=np.int32)
    d = tmh.shard_local_blocks(block, mesh, "dsp")
    assert tuple(d.shape) == (12,) and d.placements[0].is_shard(0)
    np.testing.assert_array_equal(d.to_local().numpy(), block)
    np.testing.assert_array_equal(d.full_tensor().numpy(), block)
    with pytest.raises(ValueError, match="the mesh on cpu"):
        tmh.shard_local_blocks(torch.zeros(4, device="meta"), mesh, "dsp")


def test_multihost_pipeline_single_process(no_launch_env, capsys):
    """The walkthrough as one process on the CPU: its own single-rank
    group, the planted template found at shift 0, bin 0, 8 blocks
    checkpointed."""
    out = multihost_pipeline.main(["--device", "cpu"])
    assert out == {"processes": 1, "filtered": (multihost_pipeline.TOTAL,),
                   "peak": pytest.approx(1.0, abs=1e-6), "shift": 0,
                   "bin": 0, "blocks": 8, "stale": []}
    assert "CAF peak QF2=1.000 at shift 0 bin 0" in capsys.readouterr().out

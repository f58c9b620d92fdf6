"""The port's checkpointed CAF pipeline, its ``XcorrDB`` copy and its
metrics sink, against the JAX package's on the scenario of
``tests/test_io.py::test_checkpointed_xcorr_pipeline`` (a 512-sample
template planted at shift 900 of a 2559-sample capture, blocks of 512
shifts). Rows' QF^2 within rtol 1e-4 (the CAF gate), bins exact, blobs
byte-equal where the inputs are equal."""

import json
import sqlite3

import numpy as np
import pytest
import torch

from pydsproutines_tpu.io.xcorrdb import XcorrDB as JaxDB
from pydsproutines_tpu.models.pipeline import \
    CheckpointedXcorrPipeline as JaxPipe
from pydsproutines_tpu.utils import metrics as jmetrics
from pydsproutines_tpu_torch.io import XcorrDB
from pydsproutines_tpu_torch.models import CheckpointedXcorrPipeline
from pydsproutines_tpu_torch.ops.xcorr import fast_xcorr
from pydsproutines_tpu_torch.utils import metrics


def _scene():
    rng = np.random.default_rng(3)
    n, nshifts = 512, 2048
    template = (rng.standard_normal(n)
                + 1j * rng.standard_normal(n)).astype(np.complex64)
    rx = (rng.standard_normal(nshifts + n)
          + 1j * rng.standard_normal(nshifts + n)).astype(np.complex64) * 0.3
    rx[900:900 + n] += template
    return template, rx


def _rows(db, table):
    return sorted(db.select_results(table), key=lambda r: r[1])


def test_pipeline_matches_jax_and_resumes(tmp_path):
    template, rx = _scene()
    jdb = JaxDB(str(tmp_path / "jax.db"))
    jpipe = JaxPipe(jdb, "job1", template, fs=1e6, block_shifts=512)
    assert jpipe.run(rx) == 4

    db = XcorrDB(str(tmp_path / "port.db"))
    pipe = CheckpointedXcorrPipeline(db, "job1", template, fs=1e6,
                                     block_shifts=512, device="cpu")
    assert pipe.num_blocks(rx.shape[-1]) == 4 and pipe.xcorr_path is None
    # a partial run: blocks 0-1 written by hand, then a "crash"
    for bi in range(2):
        qf2, bins = fast_xcorr(torch.from_numpy(template),
                               torch.from_numpy(rx), True,
                               shifts=np.arange(bi * 512, bi * 512 + 512))
        db.insert_1d_result("job1", pipe._base(bi), qf2.numpy(), bins.numpy())
    assert pipe.completed_blocks() == {0, 1}
    assert pipe.run(rx) == 2                      # only the missing blocks
    assert pipe.completed_blocks() == {0, 1, 2, 3}
    assert pipe.run(rx) == 0                      # idempotent
    assert pipe.xcorr_path == "plain"             # a CPU tensor's route

    rows, jrows = _rows(db, "job1"), _rows(jdb, "job1")
    assert len(rows) == len(jrows) == 4
    for r, j in zip(rows, jrows):
        assert r[:13] == j[:13]                   # the scan's key columns
        q, b = XcorrDB.regenerate_1d(r[-3], r[-2])
        jq, jb = JaxDB.regenerate_1d(j[-3], j[-2])
        np.testing.assert_array_equal(b, jb)
        np.testing.assert_allclose(q, jq, rtol=1e-4)
    shift, qf2v, fbin = pipe.peak()
    jshift, jqf2v, jfbin = jpipe.peak()
    assert (shift, fbin) == (jshift, jfbin) == (900, 0)
    assert qf2v == pytest.approx(jqf2v, rel=1e-4) and qf2v > 0.5
    assert db.get_metadata("job1") == jdb.get_metadata("job1")


def test_pipeline_drops_the_tail_shifts_as_jax_does(tmp_path):
    """2049 shifts in blocks of 512: four blocks, the last shift unsearched
    (a JAX quirk the port follows)."""
    template, rx = _scene()
    db = XcorrDB(str(tmp_path / "tail.db"))
    pipe = CheckpointedXcorrPipeline(db, "t", template, 1e6, block_shifts=512,
                                     device="cpu")
    jpipe = JaxPipe(JaxDB(str(tmp_path / "jtail.db")), "t", template, 1e6,
                    block_shifts=512)
    assert pipe.num_blocks(rx.size) == jpipe.num_blocks(rx.size) == 4
    assert rx.size - template.size + 1 == 2049
    pipe.run(rx)
    covered = {int(r[1]) + k for r in db.select_results("t")
               for k in range(int(r[4]))}
    assert covered == set(range(2048))


def test_pipeline_reports_the_route_its_core_dispatched(tmp_path,
                                                        monkeypatch):
    """``xcorr_path`` is the (path, reason) fast_xcorr's core routed each
    block by, asked once a block with the step found in the block's host
    shifts (1: the uniform-sweep kernel's case), not the router asked
    again."""
    from pydsproutines_tpu_torch.ops import xcorr
    template, rx = _scene()
    route, asked = xcorr.select_xcorr_path, []

    def spy(n, dtype, step, device, *args):
        path, reason = route(n, dtype, step, device, *args)
        asked.append(step)
        return path, f"{reason} [block {len(asked)}]"

    monkeypatch.setattr(xcorr, "select_xcorr_path", spy)
    pipe = CheckpointedXcorrPipeline(XcorrDB(str(tmp_path / "r.db")), "r",
                                     template, 1e6, block_shifts=512,
                                     device="cpu")
    assert pipe.run(rx) == 4
    assert asked == [1, 1, 1, 1]
    assert pipe.xcorr_path == "plain"
    assert pipe.xcorr_path_reason.endswith("[block 4]")


def test_xcorrdb_blobs_are_byte_equal(tmp_path):
    rng = np.random.default_rng(1)
    qf2 = rng.random(300)
    fi = rng.integers(0, 2**20, 300)
    caf = rng.random((7, 11))
    base = dict(time_sec=3, tidx=4096, cutoutlen=512, td_scan_start=1.5,
                td_scan_numsteps=300, td_scan_step=1.0, desc=b"x")
    dbs = []
    for cls, name in ((XcorrDB, "p.db"), (JaxDB, "j.db")):
        db = cls(str(tmp_path / name))
        for xt, tbl in ((0, "peaks"), (1, "rows"), (2, "cafs")):
            db.create_xcorr_results_table(tbl, 3e8, 1_000_000, "a", "b", xt,
                                          desc=b"d")
        db.insert_peak_result("peaks", base, 0.7, 1e-4, 1e-9, 12.5, 0.1)
        db.insert_1d_result("rows", base, qf2, fi)
        db.insert_1d_result("rows", {**base, "tidx": 0}, qf2[::-1], fi, fi)
        db.insert_2d_result("cafs", base, caf)
        db.close()
        dbs.append(sqlite3.connect(str(tmp_path / name)))
    for tbl in ("xcorr_metadata", "peaks", "rows", "cafs"):
        q = f'SELECT * FROM "{tbl}" ORDER BY rowid'
        assert dbs[0].execute(q).fetchall() == dbs[1].execute(q).fetchall()
    row = dbs[0].execute('SELECT qf2, freqIdx FROM rows').fetchone()
    np.testing.assert_array_equal(XcorrDB.regenerate_1d(*row)[1], fi)
    caf_blob = dbs[0].execute("SELECT caf FROM cafs").fetchone()[0]
    np.testing.assert_array_equal(XcorrDB.regenerate_2d(caf_blob, 7), caf)


def test_metrics_sink_records_match_jax(tmp_path):
    template, rx = _scene()
    recs = {}
    for name, sink_mod in (("port", metrics), ("jax", jmetrics)):
        path = tmp_path / name / "m.jsonl"
        with sink_mod.MetricsSink(path, process_id=2) as sink:
            if name == "port":
                CheckpointedXcorrPipeline(
                    XcorrDB(str(tmp_path / "mp.db")), "m", template, 1e6,
                    block_shifts=1024, metrics=sink, device="cpu").run(rx)
            else:
                JaxPipe(JaxDB(str(tmp_path / "mj.db")), "m", template, 1e6,
                        block_shifts=1024, metrics=sink).run(rx)
            with sink.timer("outer", stage="x"):
                pass
        recs[name] = sink_mod.read_metrics(tmp_path / name)
    port, ref = recs["port"], recs["jax"]
    assert [r["name"] for r in port] == [r["name"] for r in ref] == [
        "xcorr.block_seconds", "xcorr.block_seconds",
        "xcorr.blocks_completed", "outer"]
    for p, j in zip(port, ref):
        assert set(p) == set(j) and p["proc"] == 2
        for k in ("block", "nblocks", "unit", "ok", "stage"):
            assert p.get(k) == j.get(k)
        if "peak_qf2" in p:
            assert p["peak_qf2"] == pytest.approx(j["peak_qf2"], rel=1e-4)
    assert port[2]["value"] == ref[2]["value"] == 2
    summ = metrics.summarize(port)
    assert summ["xcorr.block_seconds"]["count"] == 2
    assert metrics.tail_progress(tmp_path / "port", "xcorr.")[
        "xcorr.blocks_completed"]["value"] == 2
    # a torn trailing line is skipped by the reader
    with open(tmp_path / "port" / "m.jsonl", "a") as fh:
        fh.write('{"ts": 1, "name": "torn"')
    assert len(metrics.read_metrics(tmp_path / "port")) == 4
    assert json.loads(json.dumps(summ)) == summ

"""Xcorr results database (sqlite).

Reference semantics: xcorrDatabase/_core.py — a metadata table
(xcorr_metadata: data_tblname/fc/fs/s1/s2/xctype/desc, :28-44), per-result
scan-parameter base columns (td/fd/rfd start/numsteps/step, :47-69), and three
result layouts: type 0 scalar peaks, type 1 1-D qf2+freqIdx blobs, type 2 full
2-D CAF blob (:77-119). Blobs are raw numpy bytes; regeneration uses
np.frombuffer (:259-262). Implemented directly on sqlite3 (the reference
depends on the external 'sew' wrapper).

A copy of the JAX package's ``pydsproutines_tpu/io/xcorrdb.py``, which is
numpy only: the port keeps its own because importing any module of that
package runs its ``__init__``, which imports JAX.
"""

from __future__ import annotations

import sqlite3

import numpy as np

_BASE_COLS = [
    ("time_sec", "INTEGER"),
    ("tidx", "INTEGER"),
    ("cutoutlen", "INTEGER"),
    ("td_scan_start", "REAL"),
    ("td_scan_numsteps", "INTEGER"),
    ("td_scan_step", "REAL"),
    ("fd_scan_start", "REAL"),
    ("fd_scan_numsteps", "INTEGER"),
    ("fd_scan_step", "REAL"),
    ("rfd_scan_start", "REAL"),
    ("rfd_scan_numsteps", "INTEGER"),
    ("rfd_scan_step", "REAL"),
    ("desc", "BLOB"),
]

_TYPE_COLS = {
    0: [("qf2", "REAL"), ("td", "REAL"), ("td_sigma", "REAL"),
        ("fd", "REAL"), ("fd_sigma", "REAL"),
        ("rfd", "REAL"), ("rfd_sigma", "REAL")],
    1: [("qf2", "BLOB"), ("freqIdx", "BLOB"), ("rfdIdx", "BLOB")],
    2: [("caf", "BLOB")],
}


class XcorrDB:
    """CAF/xcorr results persistence, keyed by unique scan parameters so
    reprocessing is skippable (checkpoint-at-results-level, SURVEY.md §5)."""

    TYPE_PEAKVALUES = 0
    TYPE_1D = 1
    TYPE_2D = 2

    def __init__(self, dbpath: str = "xcorrs.db"):
        self.dbpath = dbpath
        self.con = sqlite3.connect(dbpath)
        self.cur = self.con.cursor()
        self.cur.execute(
            "CREATE TABLE IF NOT EXISTS xcorr_metadata("
            "data_tblname TEXT, fc REAL, fs INTEGER, s1 TEXT, s2 TEXT, "
            "xctype INTEGER, desc BLOB, UNIQUE(data_tblname))")
        self.con.commit()

    # ------------------------------------------------------------------
    def create_xcorr_results_table(self, results_tblname: str, fc: float,
                                   fs: int, s1: str, s2: str, xctype: int,
                                   desc: bytes | None = None):
        """Create a results table + register it in the metadata table
        (reference createXcorrResultsTable, _core.py:161)."""
        if xctype not in _TYPE_COLS:
            raise ValueError("xctype must be 0, 1 or 2")
        cols = _BASE_COLS + _TYPE_COLS[xctype]
        colsql = ", ".join(f"{name} {typ}" for name, typ in cols)
        unique = ", ".join(name for name, _ in _BASE_COLS)
        self.cur.execute(
            f'CREATE TABLE IF NOT EXISTS "{results_tblname}"'
            f"({colsql}, UNIQUE({unique}))")
        self.cur.execute(
            "INSERT OR REPLACE INTO xcorr_metadata VALUES(?,?,?,?,?,?,?)",
            (results_tblname, fc, fs, s1, s2, xctype, desc))
        self.con.commit()

    def get_metadata(self, results_tblname: str):
        return self.cur.execute(
            "SELECT * FROM xcorr_metadata WHERE data_tblname=?",
            (results_tblname,)).fetchone()

    def tables(self):
        return [r[0] for r in self.cur.execute(
            "SELECT data_tblname FROM xcorr_metadata").fetchall()]

    # ------------------------------------------------------------------
    def _insert(self, tblname: str, base_values: dict, extra: dict):
        cols = [c for c, _ in _BASE_COLS] + list(extra.keys())
        vals = [base_values.get(c) for c, _ in _BASE_COLS] + list(extra.values())
        # sqlite treats NULL as distinct under UNIQUE; normalize the desc key
        # column so identical scan parameters really do dedupe
        desc_i = cols.index("desc")
        if vals[desc_i] is None:
            vals[desc_i] = b""
        ph = ",".join("?" * len(cols))
        self.cur.execute(
            f'INSERT OR REPLACE INTO "{tblname}"({",".join(cols)}) '
            f"VALUES({ph})", vals)
        self.con.commit()

    def insert_peak_result(self, tblname: str, base: dict, qf2: float,
                           td: float, td_sigma: float, fd: float = 0.0,
                           fd_sigma: float = 0.0, rfd: float = 0.0,
                           rfd_sigma: float = 0.0):
        """Insert a type-0 scalar peak row. ``base`` holds the scan-parameter
        columns (time_sec, tidx, cutoutlen, td/fd/rfd scan params, desc)."""
        self._insert(tblname, base, dict(
            qf2=float(qf2), td=float(td), td_sigma=float(td_sigma),
            fd=float(fd), fd_sigma=float(fd_sigma), rfd=float(rfd),
            rfd_sigma=float(rfd_sigma)))

    def insert_1d_result(self, tblname: str, base: dict, qf2: np.ndarray,
                         freq_idx: np.ndarray, rfd_idx: np.ndarray | None = None):
        """Insert a type-1 row: per-shift QF^2 (float64 blob) + peak freq
        indices (uint32 blob)."""
        self._insert(tblname, base, dict(
            qf2=np.asarray(qf2, dtype=np.float64).tobytes(),
            freqIdx=np.asarray(freq_idx, dtype=np.uint32).tobytes(),
            rfdIdx=(np.asarray(rfd_idx, dtype=np.uint32).tobytes()
                    if rfd_idx is not None else None)))

    def insert_2d_result(self, tblname: str, base: dict, caf: np.ndarray):
        """Insert a type-2 row: the full CAF matrix as a float64 blob; shape
        is regenerable from td_scan_numsteps x (columns)."""
        self._insert(tblname, base,
                     dict(caf=np.asarray(caf, dtype=np.float64).tobytes()))

    # ------------------------------------------------------------------
    def select_results(self, tblname: str, where: str = "", args=()):
        q = f'SELECT * FROM "{tblname}"'
        if where:
            q += " WHERE " + where
        return self.cur.execute(q, args).fetchall()

    @staticmethod
    def regenerate_1d(row_qf2_blob: bytes, row_freqidx_blob: bytes):
        """Blob -> numpy for type-1 rows (reference regeneration,
        _core.py:259-262)."""
        qf2 = np.frombuffer(row_qf2_blob, dtype=np.float64)
        fi = np.frombuffer(row_freqidx_blob, dtype=np.uint32)
        return qf2, fi

    @staticmethod
    def regenerate_2d(caf_blob: bytes, num_rows: int):
        caf = np.frombuffer(caf_blob, dtype=np.float64)
        return caf.reshape(num_rows, -1)

    def close(self):
        self.con.close()

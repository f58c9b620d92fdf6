"""Headless xcorr-results database browser.

Reference semantics: xcorrDatabase/viewer.py (a dearpygui
table browser, :19-342). A production compute stack is headless, so the browser
is a CLI: list tables, dump metadata + scan parameters, summarize result
rows, and render a selected type-1 (QF^2 vs time-shift) or type-2 (full CAF
heatmap) row to a PNG via matplotlib's Agg backend.

Usage:
    python -m pydsproutines_tpu_torch.viz.xcorr_viewer results.db
    python -m pydsproutines_tpu_torch.viz.xcorr_viewer results.db mytable
    python -m pydsproutines_tpu_torch.viz.xcorr_viewer results.db mytable \
        --row 0 --plot caf.png

A copy of the JAX package's ``pydsproutines_tpu/viz/xcorr_viewer.py``, which
does not import JAX: the port keeps its own because importing any module of
that package runs its ``__init__``, which imports JAX.
"""

from __future__ import annotations

import argparse

import numpy as np

from pydsproutines_tpu_torch.io.xcorrdb import XcorrDB, _BASE_COLS, _TYPE_COLS

_N_BASE = len(_BASE_COLS)


def list_tables(db: XcorrDB) -> list[str]:
    tables = db.tables()
    print(f"{len(tables)} result table(s):")
    for t in tables:
        meta = db.get_metadata(t)
        _, fc, fs, s1, s2, xctype, _ = meta
        print(f"  {t}: type {xctype}, fc={fc:g} Hz, fs={fs:g} Hz, "
              f"{s1} x {s2}")
    return tables


def describe_table(db: XcorrDB, tblname: str) -> list[tuple]:
    meta = db.get_metadata(tblname)
    if meta is None:
        raise SystemExit(f"table {tblname!r} not in xcorr_metadata")
    xctype = meta[5]
    rows = db.select_results(tblname)
    print(f"table {tblname}: type {xctype}, {len(rows)} row(s)")
    names = [c for c, _ in _BASE_COLS] + [c for c, _ in _TYPE_COLS[xctype]]
    for i, row in enumerate(rows):
        base = dict(zip(names, row))
        line = (f"  [{i}] t={base['time_sec']} tidx={base['tidx']} "
                f"cutoutlen={base['cutoutlen']} "
                f"td[{base['td_scan_start']}:+{base['td_scan_numsteps']}"
                f"x{base['td_scan_step']}]")
        if xctype == XcorrDB.TYPE_PEAKVALUES:
            line += (f" qf2={base['qf2']:.4f} td={base['td']:.6g}"
                     f"±{base['td_sigma']:.3g} fd={base['fd']:.6g}")
        elif xctype == XcorrDB.TYPE_1D:
            qf2, fi = XcorrDB.regenerate_1d(base["qf2"], base["freqIdx"])
            k = int(np.argmax(qf2))
            line += (f" peak qf2={qf2[k]:.4f} at step {k} "
                     f"(freqIdx {int(fi[k])})")
        else:
            caf = XcorrDB.regenerate_2d(base["caf"],
                                        int(base["td_scan_numsteps"]))
            r, c = np.unravel_index(int(np.argmax(caf)), caf.shape)
            line += f" CAF {caf.shape} peak={caf[r, c]:.4f} at ({r}, {c})"
        print(line)
    return rows


def plot_row(db: XcorrDB, tblname: str, row_idx: int, out_png: str) -> str:
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    meta = db.get_metadata(tblname)
    xctype = meta[5]
    rows = db.select_results(tblname)
    if not 0 <= row_idx < len(rows):
        raise SystemExit(f"row {row_idx} out of range (have {len(rows)})")
    names = [c for c, _ in _BASE_COLS] + [c for c, _ in _TYPE_COLS[xctype]]
    base = dict(zip(names, rows[row_idx]))
    td0 = base["td_scan_start"]
    dtd = base["td_scan_step"] or 1.0
    ntd = int(base["td_scan_numsteps"])
    td_axis = td0 + dtd * np.arange(ntd)

    fig, ax = plt.subplots(figsize=(8, 4.5))
    if xctype == XcorrDB.TYPE_1D:
        qf2, _ = XcorrDB.regenerate_1d(base["qf2"], base["freqIdx"])
        ax.plot(td_axis[:len(qf2)], qf2)
        ax.set_xlabel("time shift")
        ax.set_ylabel("QF$^2$")
    elif xctype == XcorrDB.TYPE_2D:
        caf = XcorrDB.regenerate_2d(base["caf"], ntd)
        fd0 = base["fd_scan_start"]
        dfd = base["fd_scan_step"] or 1.0
        im = ax.imshow(caf.T, aspect="auto", origin="lower",
                       extent=(td_axis[0], td_axis[-1],
                               fd0, fd0 + dfd * caf.shape[1]))
        fig.colorbar(im, ax=ax, label="QF$^2$")
        ax.set_xlabel("time shift")
        ax.set_ylabel("freq shift")
    else:
        ax.stem([base["td"]], [base["qf2"]])
        ax.set_xlabel("td")
        ax.set_ylabel("QF$^2$")
    ax.set_title(f"{tblname} row {row_idx} (type {xctype})")
    fig.tight_layout()
    fig.savefig(out_png, dpi=110)
    plt.close(fig)
    print(f"wrote {out_png}")
    return out_png


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("dbpath")
    ap.add_argument("table", nargs="?", help="table to describe")
    ap.add_argument("--row", type=int, default=None,
                    help="row index to plot (with --plot)")
    ap.add_argument("--plot", default=None, metavar="OUT_PNG",
                    help="render the selected row to a PNG")
    args = ap.parse_args(argv)

    db = XcorrDB(args.dbpath)
    try:
        if args.table is None:
            list_tables(db)
        else:
            describe_table(db, args.table)
            if args.plot is not None:
                plot_row(db, args.table, args.row or 0, args.plot)
    finally:
        db.close()


if __name__ == "__main__":
    main()

"""The port's viz layer (copies of the JAX package's matplotlib plots, the
xcorr database CLI viewer, and the web config editor and results viewer)
against the JAX package's.

Plots take tensors (the port's ``_np`` copies them to the host) and render
to PNG under the Agg backend; a plot's data must equal the JAX package's
plot of the same numpy input (``assert_array_equal``: both draw the same
numpy arrays). The web servers' JSON answers must equal the JAX servers'
for the same files.
"""

import json
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import scipy.signal as sps
import torch

import pydsproutines_tpu.viz as jviz
import pydsproutines_tpu.viz.plots as jplots
from pydsproutines_tpu.viz.configeditor import ConfigWebEditor as JaxEditor
from pydsproutines_tpu.viz.webviewer import XcorrWebViewer as JaxViewer
from pydsproutines_tpu_torch import viz
from pydsproutines_tpu_torch.io import DSPConfig, XcorrDB
from pydsproutines_tpu_torch.viz import plots, xcorr_viewer
from pydsproutines_tpu_torch.viz.configeditor import ConfigWebEditor
from pydsproutines_tpu_torch.viz.webviewer import XcorrWebViewer


@pytest.fixture()
def plt():
    mpl = pytest.importorskip("matplotlib")
    mpl.use("Agg")
    import matplotlib.pyplot as pyplot
    yield pyplot
    pyplot.close("all")


def test_viz_exports_every_jax_name():
    assert set(jviz.__all__) <= set(viz.__all__)


def _lines(fig):
    return [(np.asarray(ln.get_xdata()), np.asarray(ln.get_ydata()))
            for ax in fig.axes for ln in ax.get_lines()]


def _same_lines(f1, f2):
    a, b = _lines(f1), _lines(f2)
    assert len(a) == len(b) > 0
    for (x1, y1), (x2, y2) in zip(a, b):
        np.testing.assert_array_equal(x1, x2)
        np.testing.assert_array_equal(y1, y2)


def test_line_plots_of_tensors_equal_jax(plt, tmp_path):
    rng = np.random.default_rng(3)
    x = (rng.standard_normal(128)
         + 1j * rng.standard_normal(128)).astype(np.complex64)
    t = torch.from_numpy(x)
    pairs = [
        (plots.plot_amp_time([t], [1.0], labels=["a"]),
         jplots.plot_amp_time([x], [1.0], labels=["a"])),
        (plots.plot_spectra(t, 1.0), jplots.plot_spectra(x, 1.0)),
        (plots.plot_xcorr_results_1d(torch.arange(10), t.real[:10],
                                     t.imag[:10]),
         jplots.plot_xcorr_results_1d(np.arange(10), x.real[:10],
                                    x.imag[:10])),
        (plots.plot_filter_response(torch.full((8,), 0.125,
                                                dtype=torch.float64)),
         jplots.plot_filter_response(np.ones(8) / 8)),
        (plots.plot_real_imag(t, fs=1e3, label="s"),
         jplots.plot_real_imag(x, fs=1e3, label="s")),
        (plots.plot_angles(t, fs=1e3, unwrap=True),
         jplots.plot_angles(x, fs=1e3, unwrap=True)),
    ]
    for i, ((fig, _), (jfig, _)) in enumerate(pairs):
        _same_lines(fig, jfig)
        fig.savefig(tmp_path / f"p{i}.png")
        assert (tmp_path / f"p{i}.png").stat().st_size > 1000


def test_image_plots_of_tensors_render(plt, tmp_path):
    """Each remaining plot renders a tensor input to PNG, as its JAX twin
    renders the numpy array (tests/test_extras.py's breadth tests)."""
    rng = np.random.default_rng(5)
    ch = (rng.standard_normal((64, 6))
          + 1j * rng.standard_normal((64, 6))).astype(np.complex64)
    caf = torch.from_numpy(rng.standard_normal((20, 16)) ** 2)
    syms = torch.from_numpy(np.exp(2j * np.pi * rng.integers(0, 4, 64) / 4))
    pts = np.cumsum(rng.standard_normal((30, 2)), axis=0)
    figs = {
        "constellation": plots.plot_constellation(syms),
        "caf_heatmap": plots.plot_caf_heatmap(caf),
        "specgram": plots.plot_specgram(syms.repeat(32), 1.0, nfft=256),
        "channels": plots.plot_amp_time_channels(torch.from_numpy(ch),
                                                 chnl_fs=1e3,
                                                 equal_y_scale=True),
        "channel_heatmap": plots.plot_channel_heatmap(torch.from_numpy(ch),
                                                      chnl_fs=1e3, fc=10e3),
        "surface": plots.plot_caf_surface(caf, shifts=torch.arange(20),
                                          freqs=np.linspace(-1e3, 1e3, 16)),
        "freqz": plots.plot_freqz([torch.from_numpy(sps.firwin(64, 0.25)),
                                   sps.firwin(128, 0.25)], cutoff=0.25,
                                  show_phase=True),
        "trajectory": plots.plot_trajectory_2d(
            torch.from_numpy(pts), torch.from_numpy(np.gradient(pts, axis=0))),
        "delta": plots.plot_delta_funcs(torch.tensor([2, 7, 30]),
                                        [1.0, -0.5, 2.0], label="taps"),
        "heatmap": plots.plot_heatmap(caf, x0=-20.0, xscale=0.5),
        "phasor": plots.plot_phasor_vs_time(syms, fs=1e3),
        "possible": plots.plot_possible_constellations(syms, 4),
    }
    assert len(figs["channels"][1]) == 6
    for name, (fig, _) in figs.items():
        fig.savefig(tmp_path / f"{name}.png")
        assert (tmp_path / f"{name}.png").stat().st_size > 1000, name
    fig, ax = plots.plot_amp_time([syms.abs()], [1.0], labels=["a"])
    assert plots.mpl_btn_toggle(ax.get_lines(), fig) is not None
    px, py = plots.reverse_map_to_pixels([10.0], [0.5], ax)
    assert px.shape == (1,) and np.isfinite(px[0]) and np.isfinite(py[0])
    plots.close_all_figs()
    assert not plt.get_fignums()


def _results_db(module_db, path):
    db = module_db(str(path))
    base = dict(time_sec=1, tidx=0, cutoutlen=100, td_scan_start=-8.0,
                td_scan_numsteps=32, td_scan_step=1.0, fd_scan_start=-8.0,
                fd_scan_numsteps=16, fd_scan_step=1.0, rfd_scan_start=0.0,
                rfd_scan_numsteps=0, rfd_scan_step=0.0)
    db.create_xcorr_results_table("t1", 1e9, 1_000_000, "a", "b", 1)
    qf2 = np.zeros(32)
    qf2[7] = 0.9
    db.insert_1d_result("t1", base, qf2, np.arange(32))
    db.create_xcorr_results_table("t2", 1e9, 1_000_000, "a", "b", 2)
    db.insert_2d_result("t2", base, np.random.default_rng(0).random((32, 16)))
    db.create_xcorr_results_table("t0", 1e9, 1_000_000, "a", "b", 0)
    db.insert_peak_result("t0", dict(base), qf2=0.91, td=3.0, td_sigma=0.1,
                          fd=12.0, fd_sigma=0.5)
    db.close()
    return str(path)


def test_xcorr_viewer_cli_equals_jax(plt, tmp_path, capsys):
    from pydsproutines_tpu.viz import xcorr_viewer as jxv
    dbp = _results_db(XcorrDB, tmp_path / "v.db")
    for args in ([dbp], [dbp, "t1"], [dbp, "t2"]):
        xcorr_viewer.main(args)
        ours = capsys.readouterr().out
        jxv.main(args)
        assert ours == capsys.readouterr().out
    xcorr_viewer.main([dbp, "t1"])
    assert "peak qf2=0.9000 at step 7" in capsys.readouterr().out
    png = str(tmp_path / "caf.png")
    xcorr_viewer.main([dbp, "t2", "--row", "0", "--plot", png])
    assert Path(png).stat().st_size > 1000


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _post(url, body):
    req = urllib.request.Request(
        url, data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            return r.status, json.load(r)
    except urllib.error.HTTPError as e:
        return e.code, json.load(e)


@pytest.fixture()
def viewers(tmp_path):
    """The port's and the JAX package's web viewers over one database
    written by the port's XcorrDB."""
    dbp = _results_db(XcorrDB, tmp_path / "x.db")
    served = []
    for cls in (XcorrWebViewer, JaxViewer):
        srv, port = cls(dbp).serve_background()
        served.append((srv, f"http://127.0.0.1:{port}"))
    yield [base for _, base in served]
    for srv, _ in served:
        srv.shutdown()


def _rowid(base, table):
    rows = json.loads(_get(f"{base}/api/rows?db=0&table={table}")[1])
    return dict(zip(rows["cols"], rows["rows"][0]))["_rowid"]


def test_webviewer_answers_equal_jax(viewers):
    ours, theirs = viewers
    rid = {t: _rowid(ours, t) for t in ("t0", "t1", "t2")}
    paths = ["/", "/api/dbs", "/api/rows?db=0&table=t1",
             "/api/rows?db=0&table=nope", "/nothing",
             f"/api/blob?db=0&table=t1&rowid={rid['t1']}&col=freqIdx"]
    paths += [f"/api/result?db=0&table={t}&rowid={r}" for t, r in rid.items()]
    for path in paths:
        assert _get(ours + path) == _get(theirs + path), path
    d = json.loads(_get(f"{ours}/api/result?db=0&table=t1&rowid="
                        f"{rid['t1']}")[1])
    assert d["peak"]["qf2"] == pytest.approx(0.9) and d["peak"]["freq_idx"] == 7


INI = """\
[src_usrpA]
srcdir = /captures/a
fs = 1000000.0
fc = 1500000000.0
conjSamples = false
headerBytes = 0

[sig_pager]
baud = 512.0
numBurstBits = 640

[pro_main]
src = usrpA
sig = pager
numTaps = 128

[ws_daily]
pro_main
"""


def test_config_editor_answers_equal_jax(tmp_path):
    """The same edits through both editors leave the same INI files, read
    back through the port's DSPConfig; the answers are equal."""
    bases, paths, servers = [], [], []
    for k, cls in enumerate((ConfigWebEditor, JaxEditor)):
        path = tmp_path / f"dsp{k}.ini"
        path.write_text(INI)
        srv, port = cls(str(path)).serve_background()
        servers.append(srv)
        bases.append(f"http://127.0.0.1:{port}")
        paths.append(path)
    try:
        assert _get(bases[0] + "/api/schema") == _get(bases[1] + "/api/schema")
        confs = [json.loads(_get(b + "/api/config?file=0")[1]) for b in bases]
        assert [c.pop("path") for c in confs] == [str(p) for p in paths]
        assert confs[0] == confs[1]
        edits = [("/api/set", {"file": 0, "section": "src_usrpA",
                               "key": "fs", "value": "2000000.0"}),
                 ("/api/set", {"file": 0, "section": "src_usrpA",
                               "key": "fs", "value": "fast"}),
                 ("/api/addsection", {"file": 0, "kind": "signal",
                                      "name": "beacon"}),
                 ("/api/addsection", {"file": 0, "kind": "signal",
                                      "name": "beacon"}),
                 ("/api/delkey", {"file": 0, "section": "pro_main",
                                  "key": "numTaps"}),
                 ("/api/delsection", {"file": 0, "section": "nope"})]
        for url, body in edits:
            ours, theirs = (_post(b + url, body) for b in bases)
            assert ours == theirs, (url, body)
        assert paths[0].read_text() == paths[1].read_text()
        cfg = DSPConfig(str(paths[0]))
        assert cfg.get_src("usrpA").fs == 2000000.0
        assert "sig_beacon" in cfg.sections()
        assert cfg.get_process("main").get("numTaps") is None
    finally:
        for srv in servers:
            srv.shutdown()

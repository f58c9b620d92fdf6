"""The port's capture readers, databases and INI config (copies of the JAX
package's host-only ``io/`` modules) against the JAX package, on the same
files made from a seed, and the streaming loader feeding the port's
channelizer.

The copies are numpy and sqlite: their results must be equal to the JAX
package's (``assert_array_equal`` / ``==``). The channelizer over streamed
frames is held to one channelisation of the whole capture within max|d| /
max 1e-5 (the WOLA parity bound of tests/test_torch_wola.py).
"""

import os
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

import pydsproutines_tpu.io as jio
import pydsproutines_tpu.io.binfiles as jbin
from pydsproutines_tpu.ops.wola import Channeliser as JaxChanneliser
from pydsproutines_tpu_torch import io
from pydsproutines_tpu_torch.io import binfiles
from pydsproutines_tpu_torch.ops import Channeliser

REPO = Path(__file__).resolve().parents[1]


def _write(path, data_c64):
    data_c64.view(np.float32).astype(np.int16).tofile(path)


def _folder(tmp_path, num_files=6, samps=128, t0=1000, gap_at=None,
            loud=()):
    rng = np.random.default_rng(42)
    arrays = []
    for i in range(num_files):
        t = t0 + i + (2 if gap_at is not None and i >= gap_at else 0)
        data = (rng.integers(-100, 100, samps)
                + 1j * rng.integers(-100, 100, samps)).astype(np.complex64)
        if i in loud:
            data[5] = 30000
        _write(os.path.join(tmp_path, f"{t}.bin"), data)
        arrays.append(data)
    return arrays


def test_io_exports_every_jax_name():
    assert set(jio.__all__) <= set(io.__all__)


def test_native_libraries_resolve_to_the_repo():
    """``_NATIVE_PATHS`` / ``_STREAM_PATHS`` reach ``native/`` two levels up
    from the port's ``io/`` as from the JAX package's."""
    for ours, theirs in ((binfiles._NATIVE_PATHS, jbin._NATIVE_PATHS),
                         (binfiles._STREAM_PATHS, jbin._STREAM_PATHS)):
        assert os.path.abspath(ours[0]) == os.path.abspath(theirs[0])
        assert Path(os.path.abspath(ours[0])).parent == REPO / "native"
    assert (binfiles._native is None) == (jbin._native is None)
    assert (binfiles._stream_native is None) == (jbin._stream_native is None)


def test_bin_reads_equal_jax(tmp_path):
    rng = np.random.default_rng(0)
    data = (rng.integers(-1000, 1000, 256)
            + 1j * rng.integers(-1000, 1000, 256)).astype(np.complex64)
    p = str(tmp_path / "a.bin")
    _write(p, data)
    for kw in (dict(num_samps=256), dict(num_samps=16, offset=40),
               dict(num_samps=-1)):
        got, ref = io.simple_bin_read(p, **kw), jio.simple_bin_read(p, **kw)
        assert got.dtype == ref.dtype == np.complex64
        np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(io.simple_bin_read(p, 256), data)
    arrays = _folder(str(tmp_path), num_files=5, samps=64)
    paths = sorted(str(p) for p in tmp_path.glob("1*.bin"))
    got = io.multi_bin_read(paths, 64, threads=3)
    np.testing.assert_array_equal(got, jio.multi_bin_read(paths, 64))
    np.testing.assert_array_equal(got, np.concatenate(arrays))
    f32 = np.arange(32, dtype=np.float32)
    f32.tofile(str(tmp_path / "f32.bin"))
    got = io.multi_bin_read([str(tmp_path / "f32.bin")], 16,
                            in_dtype=np.float32)
    assert got.dtype == np.complex64
    np.testing.assert_array_equal(got.view(np.float32), f32)


@pytest.mark.parametrize("x,clip", [(100 + 100j, False), (32500 + 0j, True),
                                    (0j, False), (-32768j, True)])
def test_is_int16_clipping_equals_jax(x, clip):
    a = np.array([x], dtype=np.complex64)
    assert io.is_int16_clipping(a) == jio.is_int16_clipping(a) == clip


def test_folder_readers_equal_jax(tmp_path):
    arrays = _folder(str(tmp_path), num_files=6, samps=128)
    got, ref = io.FolderReader(str(tmp_path), 128), \
        jio.FolderReader(str(tmp_path), 128)
    for r in (got, ref):
        r.filepaths.sort()
        r.filenames.sort()
    for n, prefetch in ((2, 2), (2, 0), (1, 1)):
        (d1, f1), (d2, f2) = got.get(n, prefetch), ref.get(n, prefetch)
        np.testing.assert_array_equal(d1, d2)
        assert f1 == f2
    assert got.has_more_files == ref.has_more_files
    np.testing.assert_array_equal(
        io.FolderReader(str(tmp_path), 128).get(1)[0].size, 128)

    sr, jsr = (m.SortedFolderReader(str(tmp_path), 128) for m in (io, jio))
    assert sr.get_final_time() == jsr.get_final_time() == 1005
    for a, b in zip(sr.get(3), jsr.get(3)):
        np.testing.assert_array_equal(a, b)
    sr.start_at_time(1001)
    d, p = sr.get_file_by_time(1001)
    np.testing.assert_array_equal(d, arrays[1])


def test_group_reader_and_database_equal_jax(tmp_path):
    _folder(str(tmp_path), num_files=6, samps=32, t0=100, gap_at=3)
    gr, jgr = (m.GroupReader(str(tmp_path), 32) for m in (io, jio))
    assert gr.num_groups == jgr.num_groups == 2
    for _ in range(2):
        for a, b in zip(gr.get_group(), jgr.get_group()):
            np.testing.assert_array_equal(a, b)
    assert gr.has_more_groups == jgr.has_more_groups is False

    dbs = [m.GroupDatabase(str(tmp_path / f"g{k}.db"))
           for k, m in enumerate((io, jio))]
    for db in dbs:
        db.add_table("bursts")
        db.insert_group("bursts", 0, 100, 102)
        db.insert_group("bursts", 1, 105, 107)
        db.update_metatable(107)
    a, b = dbs
    assert a.get_latest_group_idx("bursts") == b.get_latest_group_idx(
        "bursts") == 1
    assert a.get_group_by_idx("bursts", 0) == b.get_group_by_idx(
        "bursts", 0) == (0, 100, 102)
    assert a.get_last_processed_time() == b.get_last_processed_time() == 107


def test_split_high_amp_subfolders_equals_jax(tmp_path):
    src = tmp_path / "cap"
    src.mkdir()
    _folder(str(src), num_files=10, samps=32, t0=2000, loud=(3, 8))
    sr, jsr = (m.SortedFolderReader(str(src), 32) for m in (io, jio))
    kw = dict(min_amp=1e3, only_extract_times=True)
    times = sr.split_high_amp_subfolders(str(tmp_path / "o1"), **kw)
    assert times == jsr.split_high_amp_subfolders(str(tmp_path / "o2"), **kw)
    assert times == [2002, 2003, 2004, 2007, 2008, 2009]
    kw = dict(min_amp=1e3, only_extract_groups=True)
    assert (sr.split_high_amp_subfolders(str(tmp_path / "o1"), **kw)
            == jsr.split_high_amp_subfolders(str(tmp_path / "o2"), **kw))
    assert sr.split_high_amp_subfolders(str(tmp_path / "o1"),
                                        min_amp=1e3) == times
    jsr.split_high_amp_subfolders(str(tmp_path / "o2"), min_amp=1e3)
    for sub in ("000000", "000001"):
        assert (sorted(os.listdir(tmp_path / "o1" / sub))
                == sorted(os.listdir(tmp_path / "o2" / sub)))
    sr.split_high_amp_subfolders(str(tmp_path / "d1"), select_times=times,
                                 use_database=True)
    rows = io.GroupDatabase(str(tmp_path / "d1" / "groups.db")).get_all_groups(
        "groups")
    assert rows == [(0, 2002, 2004), (1, 2007, 2009)]
    with pytest.raises(IndexError):
        sr.split_high_amp_subfolders(str(tmp_path / "o1"), min_amp=1e9)


INI = """
[src_mysrc]
srcdir = /data/captures
fs = 1000000
fc = 100e6
conjSamples = false
headerBytes = 0
dtype = int16
lonlatalt = 103.8,1.35,15.0

[sig_mysig]
target_fc = 100.1e6
baud = 25000
numBurstBits = 480
numGuardBits = 20
numPeriodBits = 500
numBursts = 12

[pro_myproc]
src = mysrc
sig = mysig
numTaps = 128
target_osr = 4
threshold = 2.5

[myworkspace]
pro_myproc
"""


def test_dsp_config_equals_jax(tmp_path):
    ini = tmp_path / "test.ini"
    ini.write_text(INI)
    cfg, jcfg = io.DSPConfig(str(ini)), jio.DSPConfig(str(ini))
    for attr in ("all_sources", "all_signals", "all_processes",
                 "all_workspaces"):
        assert set(getattr(cfg, attr)) == set(getattr(jcfg, attr))
    src, jsrc = cfg.get_src("mysrc"), jcfg.get_src("mysrc")
    for attr in ("fs", "fc", "lonlatalt", "conj_samples", "srcdir"):
        assert getattr(src, attr) == getattr(jsrc, attr), attr
    assert src.lonlatalt == (103.8, 1.35, 15.0)
    sig, jsig = cfg.get_sig("mysig"), jcfg.get_sig("mysig")
    for attr in ("baud", "num_period_bits", "has_channels", "target_fc"):
        assert getattr(sig, attr) == getattr(jsig, attr), attr
    proc = cfg.get_process("myproc")
    assert isinstance(proc, io.ProcessingSection)
    assert proc.num_taps == jcfg.get_process("myproc").num_taps == 128
    assert proc.src.fs == 1e6 and proc.sig.baud == 25000
    cfg.load_section("myworkspace")
    jcfg.load_section("myworkspace")
    assert set(cfg.processes) == set(jcfg.processes) == {"myproc"}
    from pydsproutines_tpu_torch.io.config import SingleProcessDSPConfig
    assert issubclass(SingleProcessDSPConfig, io.DSPConfig)


def _capture(tmp_path, nfiles=6, samps=1024, seed=5):
    rng = np.random.default_rng(seed)
    raw = rng.integers(-2000, 2000, size=(nfiles, samps * 2)).astype(np.int16)
    paths = []
    for i in range(nfiles):
        p = tmp_path / f"cap{i}.bin"
        raw[i].tofile(p)
        paths.append(str(p))
    return paths, raw.reshape(-1).astype(np.float32).view(np.complex64)


def _fallback(module, paths, samps, halo):
    """A loader forced onto its thread-pool branch, as tests/test_io.py
    forces the JAX one."""
    ldr = module.StreamingCaptureLoader(paths, samps, halo=halo,
                                        num_workers=2, ring_capacity=2)
    ldr.close()
    ldr._handle = None
    ldr._pool = ThreadPoolExecutor(max_workers=2)
    ldr._cap = 2
    ldr._futures = [ldr._pool.submit(module.simple_bin_read, f, samps)
                    for f in paths[:2]]
    ldr._submitted = 2
    ldr._tail = np.zeros(halo, np.complex64)
    return ldr


@pytest.mark.parametrize("halo", [0, 64])
@pytest.mark.parametrize("route", ["native", "fallback"])
def test_streaming_capture_loader_equals_jax(tmp_path, halo, route):
    """Frames in order, each the halo of history then the file, host numpy
    complex64, equal to the JAX loader's frame for frame."""
    samps = 1000
    paths, full = _capture(tmp_path, samps=samps)
    if route == "native":
        assert binfiles._stream_native is not None, "native stream lib"
        ours = binfiles.StreamingCaptureLoader(paths, samps, halo=halo,
                                               num_workers=3, ring_capacity=3)
        theirs = jbin.StreamingCaptureLoader(paths, samps, halo=halo,
                                             num_workers=3, ring_capacity=3)
    else:
        ours = _fallback(binfiles, paths, samps, halo)
        theirs = _fallback(jbin, paths, samps, halo)
    with ours, theirs:
        pairs = list(zip(ours, theirs))
    assert len(pairs) == len(paths)
    for (i, f), (j, g) in pairs:
        assert i == j and isinstance(f, np.ndarray)
        assert f.dtype == np.complex64 and f.shape == (halo + samps,)
        np.testing.assert_array_equal(f, g)
        np.testing.assert_array_equal(f[halo:],
                                      full[i * samps:(i + 1) * samps])
        if halo and i:
            np.testing.assert_array_equal(f[:halo],
                                          full[i * samps - halo: i * samps])


def test_streamed_frames_channelise_as_the_whole_capture(tmp_path):
    """Frames read with halo 0 and fed to one Channeliser, which carries
    its own history, give the channels of the whole capture; so does the
    JAX Channeliser on the same frames."""
    nch, taps = 16, 256
    paths, full = _capture(tmp_path, nfiles=4, samps=16 * 64)
    chan = Channeliser(taps, nch, device="cpu")
    jchan = JaxChanneliser(taps, nch)
    got, ref = [], []
    with io.StreamingCaptureLoader(paths, 16 * 64, halo=0) as ldr:
        for _, frame in ldr:
            got.append(chan.channelise(torch.from_numpy(frame)))
            ref.append(np.asarray(jchan.channelise(frame)))
    got = torch.cat(got).numpy()
    whole = Channeliser(taps, nch, device="cpu").channelise(
        torch.from_numpy(full)).numpy()
    scale = np.abs(whole).max()
    assert got.shape == whole.shape == (full.size // nch, nch)
    assert np.abs(got - whole).max() / scale < 1e-5
    assert np.abs(got - np.concatenate(ref)).max() / scale < 1e-5

"""Matplotlib plotting helpers.

Reference semantics: plotRoutines.py (plotAmpTime-style
amplitude/time traces :329, plotSpectra :544, plotConstellation :636,
plotXcorrResults1D :785, specgram/heatmaps, filter freqz). The reference
keeps matplotlib and pyqtgraph twins of everything; here only the matplotlib
backend is kept (SURVEY.md §7.8: plotting minimal, matplotlib only).

All functions accept numpy arrays or tensors (CPU or CUDA), convert to
numpy, and return (fig, ax).

A copy of the JAX package's ``pydsproutines_tpu/viz/plots.py``, which does
not import JAX: the port keeps its own because importing any module of that
package runs its ``__init__``, which imports JAX. Tensors on any device are
copied to the host first (``_np``).
"""

from __future__ import annotations

import numpy as np
import torch


def _mpl():
    import matplotlib.pyplot as plt
    return plt


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def plot_amp_time(signals, fs_list=None, labels=None, ax=None):
    """|x| against time for one or more signals (reference pgPlotAmpTime)."""
    plt = _mpl()
    if not isinstance(signals, (list, tuple)):
        signals = [signals]
    if fs_list is None:
        fs_list = [1.0] * len(signals)
    if np.isscalar(fs_list):
        fs_list = [fs_list] * len(signals)
    fig, ax = (None, ax) if ax is not None else plt.subplots()
    if fig is None:
        fig = ax.figure
    for i, (sig, fs) in enumerate(zip(signals, fs_list)):
        sig = _np(sig)
        t = np.arange(sig.size) / fs
        label = labels[i] if labels else None
        ax.plot(t, np.abs(sig), label=label)
    ax.set_xlabel("Time (s)")
    ax.set_ylabel("|x|")
    if labels:
        ax.legend()
    return fig, ax


def plot_spectra(signals, fs_list=None, labels=None, ax=None, db: bool = True):
    """Magnitude spectra on the wrapped FFT frequency axis (reference
    plotSpectra, plotRoutines.py:544)."""
    from pydsproutines_tpu_torch.utils.freq import make_freq

    plt = _mpl()
    if not isinstance(signals, (list, tuple)):
        signals = [signals]
    if fs_list is None:
        fs_list = [1.0] * len(signals)
    if np.isscalar(fs_list):
        fs_list = [fs_list] * len(signals)
    fig, ax = (None, ax) if ax is not None else plt.subplots()
    if fig is None:
        fig = ax.figure
    for i, (sig, fs) in enumerate(zip(signals, fs_list)):
        sig = _np(sig)
        spec = np.fft.fftshift(np.abs(np.fft.fft(sig)))
        f = np.fft.fftshift(make_freq(sig.size, fs).numpy())
        y = 20 * np.log10(spec + 1e-30) if db else spec
        ax.plot(f, y, label=labels[i] if labels else None)
    ax.set_xlabel("Frequency (Hz)")
    ax.set_ylabel("Magnitude (dB)" if db else "Magnitude")
    if labels:
        ax.legend()
    return fig, ax


def plot_constellation(syms, ax=None, **scatter_kwargs):
    """Scatter of complex symbols (reference plotConstellation,
    plotRoutines.py:636)."""
    plt = _mpl()
    fig, ax = (None, ax) if ax is not None else plt.subplots()
    if fig is None:
        fig = ax.figure
    syms = _np(syms)
    scatter_kwargs.setdefault("s", 4)
    ax.scatter(syms.real, syms.imag, **scatter_kwargs)
    ax.set_aspect("equal")
    ax.set_xlabel("I")
    ax.set_ylabel("Q")
    return fig, ax


def plot_xcorr_results_1d(shifts, qf2, freqs=None, ax=None):
    """QF^2 against shift, optionally with the peak-frequency track
    (reference plotXcorrResults1D, plotRoutines.py:785)."""
    plt = _mpl()
    shifts = _np(shifts)
    qf2 = _np(qf2)
    if freqs is not None:
        fig, axs = plt.subplots(2, 1, sharex=True)
        axs[0].plot(shifts, qf2)
        axs[0].set_ylabel("QF$^2$")
        axs[1].plot(shifts, _np(freqs))
        axs[1].set_ylabel("Peak freq")
        axs[1].set_xlabel("Shift (samples)")
        return fig, axs
    fig, ax = (None, ax) if ax is not None else plt.subplots()
    if fig is None:
        fig = ax.figure
    ax.plot(shifts, qf2)
    ax.set_xlabel("Shift (samples)")
    ax.set_ylabel("QF$^2$")
    return fig, ax


def plot_caf_heatmap(caf, shifts=None, freqs=None, ax=None):
    """2-D CAF heatmap (shift x frequency)."""
    plt = _mpl()
    caf = _np(caf)
    fig, ax = (None, ax) if ax is not None else plt.subplots()
    if fig is None:
        fig = ax.figure
    extent = None
    if shifts is not None and freqs is not None:
        shifts, freqs = _np(shifts), _np(freqs)
        extent = [freqs[0], freqs[-1], shifts[-1], shifts[0]]
    im = ax.imshow(caf, aspect="auto", extent=extent)
    ax.set_xlabel("Frequency")
    ax.set_ylabel("Shift")
    ax.figure.colorbar(im, ax=ax, label="QF$^2$")
    return fig, ax


def plot_specgram(x, fs: float = 1.0, nfft: int = 1024, ax=None):
    """Spectrogram convenience wrapper."""
    plt = _mpl()
    fig, ax = (None, ax) if ax is not None else plt.subplots()
    if fig is None:
        fig = ax.figure
    ax.specgram(_np(x), NFFT=nfft, Fs=fs)
    ax.set_xlabel("Time (s)")
    ax.set_ylabel("Frequency (Hz)")
    return fig, ax


def plot_filter_response(taps, fs: float = 1.0, worN: int = 4096, ax=None):
    """Filter magnitude response (reference freqz plots)."""
    import scipy.signal as sps

    plt = _mpl()
    w, h = sps.freqz(_np(taps), worN=worN, fs=fs)
    fig, ax = (None, ax) if ax is not None else plt.subplots()
    if fig is None:
        fig = ax.figure
    ax.plot(w, 20 * np.log10(np.abs(h) + 1e-30))
    ax.set_xlabel("Frequency (Hz)")
    ax.set_ylabel("Magnitude (dB)")
    return fig, ax


def plot_amp_time_channels(channels, chnl_fs: float = 1.0,
                           equal_y_scale: bool = False, fig=None):
    """Stacked per-channel |x| traces with a shared time axis — the channel
    grid view of a WOLA output (reference pgPlotAmpTimeChannels,
    plotRoutines.py:581; headless matplotlib here).

    ``channels`` is (time, num_channels) as returned by ops.wola.wola.
    Returns (fig, list of axes), channels stacked top (last) to bottom
    (first) like the reference."""
    plt = _mpl()
    ch = _np(channels)
    nch = ch.shape[1]
    if fig is None:
        fig, axes = plt.subplots(nch, 1, sharex=True,
                                 figsize=(8, max(4, 1.1 * nch)))
    else:
        axes = fig.subplots(nch, 1, sharex=True)
    axes = np.atleast_1d(axes)
    t = np.arange(ch.shape[0]) / chnl_fs
    maxamp = float(np.max(np.abs(ch))) if equal_y_scale else None
    for i, ax in enumerate(axes):
        c = nch - 1 - i
        ax.plot(t, np.abs(ch[:, c]), lw=0.7)
        ax.set_ylabel(f"ch {c}", rotation=0, ha="right", va="center")
        if equal_y_scale:
            ax.set_ylim(0, maxamp)
    axes[-1].set_xlabel("time (s)")
    return fig, list(axes)


def plot_channel_heatmap(channels, chnl_fs: float = 1.0, fc: float = 0.0,
                         db: bool = True, ax=None):
    """Time x channel-frequency power heatmap of a channelizer output — the
    dense alternative to the stacked channel grid (reference heatmap usage,
    plotRoutines.py:180 plotHeatmap / BurstDetector.pgplot overview)."""
    plt = _mpl()
    ch = _np(channels)
    power = np.abs(ch) ** 2
    if db:
        power = 10 * np.log10(np.maximum(power, 1e-30))
    # channels in FFT bin order -> center the frequency axis
    nch = ch.shape[1]
    order = np.fft.fftshift(np.arange(nch))
    freqs = fc + (np.arange(nch) - nch // 2) * chnl_fs
    if ax is None:
        fig, ax = plt.subplots()
    else:
        fig = ax.figure
    extent = [freqs[0] - chnl_fs / 2, freqs[-1] + chnl_fs / 2,
              0, ch.shape[0] / chnl_fs]
    ax.imshow(power[:, order], aspect="auto", origin="lower", extent=extent)
    ax.set_xlabel("frequency (Hz)")
    ax.set_ylabel("time (s)")
    return fig, ax


def plot_surface(xm, ym, z, cmap: str = "coolwarm", ax=None):
    """3-D surface (reference plotSurface, plotRoutines.py:148): xm/ym are
    meshgrid matrices, z the surface values — e.g. a (shift, freq) CAF."""
    plt = _mpl()
    if ax is None:
        fig = plt.figure()
        ax = fig.add_subplot(projection="3d")
    else:
        fig = ax.figure
    ax.plot_surface(_np(xm), _np(ym), _np(z), cmap=cmap)
    return fig, ax


def plot_caf_surface(caf, shifts=None, freqs=None, cmap: str = "coolwarm",
                     ax=None):
    """3-D CAF surface over (shift, freq) — the surface view of
    plot_caf_heatmap (reference pgPlotSurface usage on CAF grids,
    plotRoutines.py:105)."""
    caf = _np(caf)
    s = _np(shifts) if shifts is not None else np.arange(caf.shape[0])
    f = _np(freqs) if freqs is not None else np.arange(caf.shape[1])
    fm, sm = np.meshgrid(f, s)
    fig, ax = plot_surface(sm, fm, caf, cmap=cmap, ax=ax)
    ax.set_xlabel("shift")
    ax.set_ylabel("freq")
    ax.set_zlabel("QF$^2$")
    return fig, ax


def plot_freqz(taps, cutoff: float | None = None, show_phase: bool = False,
               fig=None):
    """Filter response(s) for one or more tap vectors — the freqz cascade
    view (reference plotFreqz, plotRoutines.py:696): amplitude in dB, shared
    normalized-frequency axis, optional unwrapped phase row, optional cutoff
    marker."""
    import scipy.signal as sps
    plt = _mpl()
    if not isinstance(taps, (list, tuple)):
        taps = [taps]
    nrows = 2 if show_phase else 1
    if fig is None:
        fig, ax = plt.subplots(nrows, 1, sharex=True)
    else:
        ax = fig.subplots(nrows, 1, sharex=True)
    ax = np.atleast_1d(ax)
    aax = ax[0]
    pax = ax[1] if show_phase else None
    for i, vt in enumerate(taps):
        vt = _np(vt)
        w, h = sps.freqz(vt, 1, max(int(vt.size), 512))
        label = f"{i}: {vt.size} taps"
        aax.plot(w / np.pi, 20 * np.log10(np.maximum(np.abs(h), 1e-12)),
                 label=label)
        if show_phase:
            pax.plot(w / np.pi, np.unwrap(np.angle(h)), label=label)
    if cutoff is not None:
        aax.axvline(cutoff, color="r", ls="--", lw=0.8)
    aax.set_ylabel("amplitude (dB)")
    aax.legend(fontsize="small")
    if show_phase:
        pax.set_ylabel("phase (rad)")
        pax.set_xlabel("normalized frequency (x pi rad/sample)")
    else:
        aax.set_xlabel("normalized frequency (x pi rad/sample)")
    return fig, ax


def plot_trajectory_2d(r_x, r_xdot=None, fmt: str = "b.",
                       quiver_scale: float | None = None, ax=None):
    """2-D trajectory with optional velocity quivers (reference
    plotTrajectory2d, plotRoutines.py:608)."""
    plt = _mpl()
    r_x = _np(r_x)
    if ax is None:
        fig, ax = plt.subplots()
    else:
        fig = ax.figure
    ax.plot(r_x[:, 0], r_x[:, 1], fmt)
    if r_xdot is not None:
        r_xdot = _np(r_xdot)
        if quiver_scale is None:
            quiver_scale = float(np.mean(np.linalg.norm(
                np.diff(r_x, axis=0), axis=1)))
        normed = r_xdot / np.linalg.norm(r_xdot, axis=1)[:, None]
        ax.quiver(r_x[:, 0], r_x[:, 1], normed[:, 0] * quiver_scale,
                  normed[:, 1] * quiver_scale, scale_units="xy",
                  angles="xy", scale=1)
    ax.axis("equal")
    return fig, ax


def close_all_figs():
    """Close every open matplotlib figure (reference closeAllFigs,
    plotRoutines.py:29)."""
    _mpl().close("all")


def plot_delta_funcs(x, h, color: str = "r", label=None, ax=None):
    """Stem-style delta functions: vertical lines of height h[i] at x[i]
    (reference pgPlotDeltaFuncs, plotRoutines.py:57)."""
    plt = _mpl()
    x = np.atleast_1d(_np(x))
    h = np.broadcast_to(np.atleast_1d(_np(h)), x.shape)
    if ax is None:
        fig, ax = plt.subplots()
    else:
        fig = ax.figure
    ax.vlines(x, 0.0, h, colors=color, label=label)
    if label:
        ax.legend()
    return fig, ax


def plot_heatmap(data, x0: float = 0.0, y0: float = 0.0, xscale: float = 1.0,
                 yscale: float = 1.0, ax=None, cmap: str = "viridis",
                 colorbar: bool = True):
    """Generic 2-D heatmap with axis scaling (reference plotHeatmap,
    plotRoutines.py:174: rows map to y, columns to x, extent from
    offsets/scales)."""
    plt = _mpl()
    data = _np(data)
    if ax is None:
        fig, ax = plt.subplots()
    else:
        fig = ax.figure
    extent = (x0, x0 + data.shape[1] * xscale,
              y0, y0 + data.shape[0] * yscale)
    im = ax.imshow(data, origin="lower", aspect="auto", extent=extent,
                   cmap=cmap)
    if colorbar:
        fig.colorbar(im, ax=ax)
    return fig, ax


def plot_real_imag(x, fs: float = 1.0, label=None, ax=None):
    """Real and imaginary parts on stacked subplots (reference plotRealImag,
    plotRoutines.py:285). ``ax``: optional (ax_re, ax_im) pair."""
    plt = _mpl()
    x = _np(x)
    t = np.arange(x.shape[-1]) / fs
    if ax is None:
        fig, (ax_re, ax_im) = plt.subplots(2, 1, sharex=True)
    else:
        ax_re, ax_im = ax
        fig = ax_re.figure
    ax_re.plot(t, x.real, label=label)
    ax_im.plot(t, x.imag, label=label)
    ax_re.set_ylabel("Re")
    ax_im.set_ylabel("Im")
    ax_im.set_xlabel("time (s)")
    if label:
        ax_re.legend()
    return fig, (ax_re, ax_im)


def plot_phasor_vs_time(x, fs: float = 1.0, ax=None):
    """3-D phasor trace: (time, Re, Im) — the reference's
    pgPlotPhasorVsTime (plotRoutines.py:238) as a matplotlib 3-D line."""
    plt = _mpl()
    x = _np(x)
    t = np.arange(x.shape[-1]) / fs
    if ax is None:
        fig = plt.figure()
        ax = fig.add_subplot(projection="3d")
    else:
        fig = ax.figure
    ax.plot(t, x.real, x.imag)
    ax.set_xlabel("time (s)")
    ax.set_ylabel("Re")
    ax.set_zlabel("Im")
    return fig, ax


def plot_angles(x, fs: float = 1.0, unwrap: bool = False, label=None,
                ax=None):
    """Phase angle against time (reference plotAngles,
    plotRoutines.py:753)."""
    plt = _mpl()
    x = _np(x)
    ang = np.angle(x)
    if unwrap:
        ang = np.unwrap(ang)
    t = np.arange(x.shape[-1]) / fs
    if ax is None:
        fig, ax = plt.subplots()
    else:
        fig = ax.figure
    ax.plot(t, ang, label=label)
    ax.set_xlabel("time (s)")
    ax.set_ylabel("angle (rad)")
    if label:
        ax.legend()
    return fig, ax


def plot_possible_constellations(syms, m: int, ax=None):
    """The m rotated constellations a PSK symbol stream could be (reference
    plotPossibleConstellations, plotRoutines.py:676): one subplot per
    rotation e^{j 2 pi r / m}."""
    plt = _mpl()
    syms = _np(syms)
    if ax is None:
        fig, axes = plt.subplots(1, m, sharey=True)
    else:
        axes = ax
        fig = axes[0].figure
    for r in range(m):
        rot = syms * np.exp(1j * 2 * np.pi * r / m)
        axes[r].plot(rot.real, rot.imag, ".")
        axes[r].set_title(f"rot {r}")
        axes[r].axis("equal")
    return fig, axes


def mpl_btn_toggle(plotted_lines, fig):
    """Check-button visibility toggles for plotted lines (reference
    mplBtnToggle, plotRoutines.py:830). Returns the CheckButtons widget
    (keep a reference alive, as matplotlib requires)."""
    from matplotlib.widgets import CheckButtons
    lines = list(plotted_lines)
    labels = [ln.get_label() for ln in lines]
    fig.subplots_adjust(right=0.8)
    rax = fig.add_axes([0.82, 0.4, 0.16, 0.05 + 0.05 * len(lines)])
    check = CheckButtons(rax, labels, [ln.get_visible() for ln in lines])

    def _toggle(label):
        ln = lines[labels.index(label)]
        ln.set_visible(not ln.get_visible())
        fig.canvas.draw_idle()

    check.on_clicked(_toggle)
    return check


def reverse_map_to_pixels(x, y, ax):
    """Map data coordinates to display pixels for an axes (reference
    reverseMapToPixels, plotRoutines.py:875). Returns (px, py) arrays."""
    pts = np.column_stack([np.atleast_1d(_np(x)), np.atleast_1d(_np(y))])
    out = ax.transData.transform(pts)
    return out[:, 0], out[:, 1]

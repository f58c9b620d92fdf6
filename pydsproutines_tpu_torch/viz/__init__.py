"""Visualization layer (matplotlib-only, reference plotRoutines.py).

Import is lazy/gated: the compute library never requires a display stack
(matplotlib is imported by a plot when it draws, never by this package).
"""

from pydsproutines_tpu_torch.viz.plots import (
    plot_amp_time,
    plot_spectra,
    plot_constellation,
    plot_xcorr_results_1d,
    plot_caf_heatmap,
    plot_specgram,
    plot_filter_response,
    plot_amp_time_channels,
    plot_channel_heatmap,
    plot_surface,
    plot_caf_surface,
    plot_freqz,
    plot_trajectory_2d,
)

__all__ = [
    "plot_amp_time",
    "plot_spectra",
    "plot_constellation",
    "plot_xcorr_results_1d",
    "plot_caf_heatmap",
    "plot_specgram",
    "plot_filter_response",
    "plot_amp_time_channels",
    "plot_channel_heatmap",
    "plot_surface",
    "plot_caf_surface",
    "plot_freqz",
    "plot_trajectory_2d",
]

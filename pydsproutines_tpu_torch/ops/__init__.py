from pydsproutines_tpu_torch.ops.demod import (get_eye_opening, lock_phase,
                                               map_syms)
from pydsproutines_tpu_torch.ops.detection import (BurstDetector, Edges,
                                                   auto_detect_threshold,
                                                   energy_detection,
                                                   find_local_maxima,
                                                   threshold_edges)
from pydsproutines_tpu_torch.ops.fft import (best_two_factor, fft_factors,
                                             find_triple)
from pydsproutines_tpu_torch.ops.filters import (StreamFilter, StreamUpfirdn,
                                                 complex_moving_sum,
                                                 fir_upfirdn,
                                                 fir_upfirdn_planes_flat,
                                                 get_upfirdn_size,
                                                 lfilter_fir, medfilt,
                                                 moving_average,
                                                 multi_moving_average,
                                                 resample_factor_wizard,
                                                 select_medfilt_path,
                                                 select_upfirdn_path, upfirdn)
from pydsproutines_tpu_torch.ops.groupxcorr import (GroupXcorr,
                                                    GroupXcorrCZT,
                                                    GroupXcorrCZTPermutations,
                                                    GroupXcorrFFT,
                                                    TemplateCrossCorrelator,
                                                    select_group_caf_path)
from pydsproutines_tpu_torch.ops.hopper.sliding import (
    sliding_multiply_normalised)
from pydsproutines_tpu_torch.ops.multicorr import MultiPreambleCorrelator
from pydsproutines_tpu_torch.ops.spectral import (CZT, IntegerMultipleFFT,
                                                  burst_fft, czt, dft,
                                                  tone_spectrum)
from pydsproutines_tpu_torch.ops.wola import Channeliser, select_wola_path, wola
from pydsproutines_tpu_torch.ops.xcorr import (
    argmax2d, argmax_and_max_last, calc_qf2, compute_fast_xcorr_complexity,
    compute_group_xcorr_czt_complexity, convert_eff_snr_to_qf2,
    convert_qf2_to_eff_snr, convert_qf2_to_snr, czt_xcorr, expected_eff_snr,
    fast_xcorr, fine_freq_time_search, gather_shift_slices,
    make_time_scan_steervec, select_xcorr_path, sigma_dfo, sigma_dto,
    theoretical_multi_peak)

__all__ = ["get_eye_opening", "lock_phase", "map_syms", "best_two_factor",
           "fft_factors", "find_triple",
           "Channeliser", "select_wola_path", "wola", "argmax_and_max_last",
           "calc_qf2", "convert_qf2_to_eff_snr", "fast_xcorr",
           "gather_shift_slices", "select_xcorr_path",
           "lfilter_fir", "StreamFilter", "upfirdn", "fir_upfirdn",
           "fir_upfirdn_planes_flat", "get_upfirdn_size", "StreamUpfirdn",
           "moving_average", "multi_moving_average", "complex_moving_sum",
           "medfilt", "resample_factor_wizard", "select_upfirdn_path",
           "select_medfilt_path",
           "Edges", "threshold_edges", "find_local_maxima",
           "auto_detect_threshold", "BurstDetector", "energy_detection",
           "CZT", "czt", "dft", "tone_spectrum", "IntegerMultipleFFT",
           "burst_fft", "MultiPreambleCorrelator", "GroupXcorrCZTPermutations",
           "GroupXcorr", "GroupXcorrCZT", "GroupXcorrFFT",
           "TemplateCrossCorrelator", "select_group_caf_path",
           "sliding_multiply_normalised", "czt_xcorr",
           "fine_freq_time_search", "make_time_scan_steervec",
           "convert_qf2_to_snr", "convert_eff_snr_to_qf2",
           "expected_eff_snr", "sigma_dto", "sigma_dfo",
           "theoretical_multi_peak", "argmax2d",
           "compute_fast_xcorr_complexity",
           "compute_group_xcorr_czt_complexity"]

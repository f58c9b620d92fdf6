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
from pydsproutines_tpu_torch.ops.wola import Channeliser, select_wola_path, wola
from pydsproutines_tpu_torch.ops.xcorr import (argmax_and_max_last, calc_qf2,
                                               convert_qf2_to_eff_snr,
                                               fast_xcorr, gather_shift_slices,
                                               select_xcorr_path)

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
           "auto_detect_threshold", "BurstDetector", "energy_detection"]

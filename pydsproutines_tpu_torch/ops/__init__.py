from pydsproutines_tpu_torch.ops.demod import (get_eye_opening, lock_phase,
                                               map_syms)
from pydsproutines_tpu_torch.ops.fft import (best_two_factor, fft_factors,
                                             find_triple)
from pydsproutines_tpu_torch.ops.wola import Channeliser, select_wola_path, wola
from pydsproutines_tpu_torch.ops.xcorr import (argmax_and_max_last, calc_qf2,
                                               convert_qf2_to_eff_snr,
                                               fast_xcorr, gather_shift_slices,
                                               select_xcorr_path)

__all__ = ["get_eye_opening", "lock_phase", "map_syms", "best_two_factor",
           "fft_factors", "find_triple",
           "Channeliser", "select_wola_path", "wola", "argmax_and_max_last",
           "calc_qf2", "convert_qf2_to_eff_snr", "fast_xcorr",
           "gather_shift_slices", "select_xcorr_path"]

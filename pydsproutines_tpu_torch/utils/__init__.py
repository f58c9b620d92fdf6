from pydsproutines_tpu_torch.utils.dtypes import (FLOAT_DTYPE,
                                                  complex_dtype_for,
                                                  real_dtype_for)
from pydsproutines_tpu_torch.utils.freq import freqshift_signal, make_freq, tone
from pydsproutines_tpu_torch.utils.timing import Timer, median_ms

__all__ = ["FLOAT_DTYPE", "complex_dtype_for", "real_dtype_for",
           "make_freq", "tone", "freqshift_signal",
           "Timer", "median_ms"]

from pydsproutines_tpu_torch.utils.dtypes import (COMPLEX_DTYPE, FLOAT_DTYPE,
                                                  complex_dtype_for,
                                                  real_dtype_for)
from pydsproutines_tpu_torch.utils.fftlen import (next_fast_len,
                                                  prev_fast_len,
                                                  prime_factors)
from pydsproutines_tpu_torch.utils.freq import freqshift_signal, make_freq, tone
from pydsproutines_tpu_torch.utils.timing import (Timer, annotate, median_ms,
                                                  trace)
from pydsproutines_tpu_torch.utils.verify import compare_values

__all__ = ["COMPLEX_DTYPE", "FLOAT_DTYPE", "complex_dtype_for",
           "real_dtype_for", "next_fast_len", "prev_fast_len",
           "prime_factors", "make_freq", "tone", "freqshift_signal",
           "compare_values", "Timer", "trace", "annotate", "median_ms"]

from pydsproutines_tpu_torch.utils.dtypes import FLOAT_DTYPE, real_dtype_for
from pydsproutines_tpu_torch.utils.freq import make_freq
from pydsproutines_tpu_torch.utils.timing import Timer, median_ms

__all__ = ["FLOAT_DTYPE", "real_dtype_for", "make_freq",
           "Timer", "median_ms"]

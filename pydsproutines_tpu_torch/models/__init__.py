from pydsproutines_tpu_torch.models.pipeline import CheckpointedXcorrPipeline
from pydsproutines_tpu_torch.models.receiver import WidebandReceiver

__all__ = ["WidebandReceiver", "CheckpointedXcorrPipeline"]

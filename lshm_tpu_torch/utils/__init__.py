from lshm_tpu_torch.utils.checkpoint import latest_step, restore_checkpoint, save_checkpoint
from lshm_tpu_torch.utils.metrics import MetricLogger

__all__ = ["MetricLogger", "save_checkpoint", "restore_checkpoint", "latest_step"]

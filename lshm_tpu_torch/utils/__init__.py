from lshm_tpu_torch.utils.checkpoint import latest_step, restore_checkpoint, save_checkpoint
from lshm_tpu_torch.utils.metrics import MetricLogger
from lshm_tpu_torch.utils.rgb import channel_to_rgb, save_image_grid

__all__ = ["MetricLogger", "save_checkpoint", "restore_checkpoint", "latest_step",
           "channel_to_rgb", "save_image_grid"]

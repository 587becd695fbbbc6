from lshm_tpu_torch.train.objective import Duals, LossWeights, cascade_objective, dual_update
from lshm_tpu_torch.train.schedule import active_group, group_mask, ramp_stage_for_epoch
from lshm_tpu_torch.train.step import TrainState, init_train_state, make_optimizer, make_train_step
from lshm_tpu_torch.train.trainer import Trainer

__all__ = [
    "Duals",
    "LossWeights",
    "cascade_objective",
    "dual_update",
    "active_group",
    "group_mask",
    "ramp_stage_for_epoch",
    "TrainState",
    "init_train_state",
    "make_optimizer",
    "make_train_step",
    "Trainer",
]

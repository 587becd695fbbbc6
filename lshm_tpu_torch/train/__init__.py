from lshm_tpu_torch.train.objective import (
    Duals,
    LossWeights,
    cascade_objective,
    dual_update,
    dual_update_from_outputs,
    loss_from_outputs,
    metrics_and_dual_update,
)
from lshm_tpu_torch.train.schedule import active_group, group_mask, ramp_stage_for_epoch
from lshm_tpu_torch.train.step import (
    TrainState,
    active_params,
    init_lbfgs_train_state,
    init_model,
    init_train_state,
    lbfgs_objective,
    make_lbfgs_train_step,
    make_optimizer,
    make_train_step,
)
from lshm_tpu_torch.train.trainer import Trainer

__all__ = [
    "Duals",
    "LossWeights",
    "cascade_objective",
    "dual_update",
    "dual_update_from_outputs",
    "loss_from_outputs",
    "metrics_and_dual_update",
    "active_group",
    "group_mask",
    "ramp_stage_for_epoch",
    "TrainState",
    "active_params",
    "init_lbfgs_train_state",
    "init_model",
    "init_train_state",
    "lbfgs_objective",
    "make_lbfgs_train_step",
    "make_optimizer",
    "make_train_step",
    "Trainer",
]

from lshm_tpu_torch.optim.lbfgs import (
    LBFGS,
    LBFGSResult,
    LBFGSState,
    lbfgs_init,
    make_lbfgs_step,
    value_and_grad,
)

__all__ = ["LBFGS", "LBFGSResult", "LBFGSState", "lbfgs_init", "make_lbfgs_step",
           "value_and_grad"]

"""Hand-written CUDA kernels of the port (sources in ``lshm_tpu_torch/csrc/``).

Each kernel module keeps a plain PyTorch version beside its wrapper and a ``launches``
dict counting the CUDA launches; ``reset_launches`` and ``launch_counts`` let a run
show that the main path went through the kernels.
"""

from lshm_tpu_torch.kernels import conv_head, khm
from lshm_tpu_torch.kernels.conv_head import enc_head
from lshm_tpu_torch.kernels.khm import khm_loss_fused

_MODULES = (khm, conv_head)


def reset_launches() -> None:
    for mod in _MODULES:
        for k in mod.launches:
            mod.launches[k] = 0


def launch_counts() -> dict[str, int]:
    return {k: v for mod in _MODULES for k, v in mod.launches.items()}


__all__ = ["enc_head", "khm_loss_fused", "reset_launches", "launch_counts"]

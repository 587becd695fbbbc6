"""Hand-written CUDA kernels of the port (sources in ``lshm_tpu_torch/csrc/``).

Each kernel module keeps a plain PyTorch version beside its wrapper and a ``launches``
dict counting the CUDA launches; ``reset_launches`` and ``launch_counts`` let a run
show that the main path went through the kernels, and ``add_launches`` lets a CUDA
graph's replay count the launches its capture recorded.  ``register_counters`` adds a
model's own counters (calls of an operation that launches no kernel of this package,
such as ``models/cascade.py::dft_calls``) to the same accounting.
"""

from lshm_tpu_torch.kernels import conv0, conv_head, dft, khm
from lshm_tpu_torch.kernels.conv_head import enc_head
from lshm_tpu_torch.kernels.khm import khm_loss_fused

_COUNTERS = [khm.launches, conv_head.launches, conv0.launches, dft.launches]


def register_counters(counts: dict[str, int]) -> None:
    """Reset, read and add ``counts`` ({counter: calls}) with the launch counters."""
    _COUNTERS.append(counts)


def reset_launches() -> None:
    for counts in _COUNTERS:
        for k in counts:
            counts[k] = 0


def launch_counts() -> dict[str, int]:
    return {k: v for counts in _COUNTERS for k, v in counts.items()}


def add_launches(counts: dict[str, int]) -> None:
    """Add ``counts`` ({counter: launches}, negative to take back) to the counters."""
    for mine in _COUNTERS:
        for k in mine:
            mine[k] += counts.get(k, 0)


__all__ = ["enc_head", "khm_loss_fused", "reset_launches", "launch_counts",
           "add_launches", "register_counters"]

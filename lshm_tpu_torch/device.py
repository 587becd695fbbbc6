"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None) -> torch.device:
    """``None`` means the card: it resolves to ``cuda`` and raises when there is none,
    rather than moving to the CPU behind the caller's back.  Tests pass ``"cpu"``."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device available; pass device='cpu' to run "
                               "on the CPU explicitly")
        return torch.device("cuda")
    return torch.device(device)


def use_exact_float32() -> None:
    """Keep float32 matrix products and convolutions in full float32 on the card.

    cuDNN runs float32 convolutions in TF32 (about three decimal digits) by default;
    the float32 compute_dtype is the path the CPU tests hold to the JAX package, so
    the port turns TF32 off for both cuBLAS and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

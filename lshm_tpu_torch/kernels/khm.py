"""Fused K-harmonic-means loss with its analytic backward (kernels K1 and K2).

Replaces ``lshm_tpu/kernels/khm_pallas.py``: ``_fwd_kernel`` (K1) and ``_bwd_kernel``
(K2), reached there through ``khm_loss_fused``.  The CUDA source is
``lshm_tpu_torch/csrc/khm.cu``; its header comment gives the math and the design.

``khm_forward`` and ``khm_backward`` are the kernel wrappers: for a CUDA tensor they
launch the kernel (or raise), for a CPU tensor they run the plain PyTorch version
beside them (``khm_forward_plain`` / ``khm_backward_plain``), which repeats the
kernel's arithmetic.  Bound on the H100 at the main path's shapes (N=420, D=256,
K=10): under 1 MB moved and ~2 MFLOP per call, so both are bound by launch latency.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from lshm_tpu_torch.kernels import _build
from lshm_tpu_torch.losses import EPS, _f32, khm_loss, pairwise_sq_dists

# launches of each CUDA kernel since the last reset (kernels.reset_launches)
launches = {"khm_fwd": 0, "khm_bwd": 0}
_MAX_SMEM = 232448                 # bytes of shared memory a block can use on Hopper

_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.library("khm")
    lib.khm_num_blocks.argtypes, lib.khm_num_blocks.restype = [_I], _I
    lib.khm_smem_bytes.argtypes = [_I, _I]
    lib.khm_smem_bytes.restype = ctypes.c_size_t
    lib.khm_fwd.argtypes = [_P, _P, _I, _I, _I, _I, _P, _P, _P, _P]
    lib.khm_fwd.restype = _I
    lib.khm_bwd.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P]
    lib.khm_bwd.restype = _I
    return lib


def _check(name: str, t: torch.Tensor, shape: tuple, device: torch.device) -> None:
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: the KHM kernel takes float32, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: the KHM kernel takes a contiguous tensor")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")


def _check_inputs(X: torch.Tensor, M: torch.Tensor, p: int) -> None:
    if X.dim() != 2 or M.dim() != 2:
        raise ValueError("khm: X [N, D] and M [K, D] must be 2-D")
    _check("X", X, tuple(X.shape), X.device)
    _check("M", M, (M.shape[0], X.shape[1]), X.device)
    if p % 2 or p < 2:
        raise ValueError(f"khm kernel: even p >= 2 only, got {p}")


def _on(t: torch.Tensor) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"khm: unsupported device {t.device}")
    return t.device.type


# ------------------------------------------------------------------ plain versions

def khm_forward_plain(X: torch.Tensor, M: torch.Tensor, p: int):
    """(loss, e [N, 1]) with the kernel's arithmetic, in plain PyTorch."""
    N, D = X.shape
    K = M.shape[0]
    t = pairwise_sq_dists(X, M) ** (p // 2) + EPS
    e = torch.sum(1.0 / t, dim=-1, keepdim=True)
    return torch.sum(K / (e + EPS)) / (N * K * D), e


def khm_backward_plain(X, M, e, g, p: int):
    """(dX, dM) with the kernel's arithmetic, in plain PyTorch."""
    N, D = X.shape
    d2 = pairwise_sq_dists(X, M)
    t = d2 ** (p // 2) + EPS
    c = (p * d2 ** (p // 2 - 1)) / ((N * D) * (e + EPS) ** 2 * t * t) * g
    dX = torch.sum(c, dim=-1, keepdim=True) * X - c @ M
    dM = torch.sum(c, dim=0)[:, None] * M - c.T @ X
    return dX, dM


# ---------------------------------------------------------------- kernel wrappers

def khm_forward(X: torch.Tensor, M: torch.Tensor, p: int):
    """K1: (loss, e [N, 1]).  CUDA kernel for a CUDA tensor, plain version on CPU."""
    _check_inputs(X, M, p)
    if _on(X) == "cpu":
        return khm_forward_plain(X, M, p)
    lib = _lib()
    (N, D), K = X.shape, M.shape[0]
    if lib.khm_smem_bytes(K, D) > _MAX_SMEM:
        raise ValueError(f"khm kernel: M [{K}, {D}] does not fit in shared memory")
    e = torch.empty((N, 1), dtype=torch.float32, device=X.device)
    partial = torch.empty(lib.khm_num_blocks(N), dtype=torch.float32, device=X.device)
    loss = torch.empty((), dtype=torch.float32, device=X.device)
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.check(lib.khm_fwd(X.data_ptr(), M.data_ptr(), N, K, D, p, e.data_ptr(),
                                 partial.data_ptr(), loss.data_ptr(), stream), "khm_fwd")
    launches["khm_fwd"] += 1
    return loss, e


def khm_backward(X: torch.Tensor, M: torch.Tensor, e: torch.Tensor, g: torch.Tensor,
                 p: int):
    """K2: (dX, dM) for the loss cotangent g (a 0-dim tensor)."""
    _check_inputs(X, M, p)
    _check("e", e, (X.shape[0], 1), X.device)
    _check("g", g, (), X.device)
    if _on(X) == "cpu":
        return khm_backward_plain(X, M, e, g, p)
    lib = _lib()
    (N, D), K = X.shape, M.shape[0]
    dX = torch.empty_like(X)
    dM = torch.empty_like(M)
    partial = torch.empty((lib.khm_num_blocks(N), K, D), dtype=torch.float32,
                          device=X.device)
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.check(lib.khm_bwd(X.data_ptr(), M.data_ptr(), e.data_ptr(), g.data_ptr(),
                                 N, K, D, p, dX.data_ptr(), partial.data_ptr(),
                                 dM.data_ptr(), stream), "khm_bwd")
    launches["khm_bwd"] += 1
    return dX, dM


class KHMLoss(torch.autograd.Function):
    """The loss with the analytic backward of the TPU kernel's custom VJP."""

    @staticmethod
    def forward(ctx, X, M, p: int):
        loss, e = khm_forward(X, M, p)
        ctx.save_for_backward(X, M, e)
        ctx.p = p
        return loss

    @staticmethod
    def backward(ctx, g):
        X, M, e = ctx.saved_tensors
        dX, dM = khm_backward(X, M, e, g.detach().float().contiguous(), ctx.p)
        return dX, dM, None


def khm_loss_fused(X: torch.Tensor, M: torch.Tensor, p: int = 4,
                   backend: str = "auto") -> torch.Tensor:
    """KHM loss: ``backend`` "pallas"/"auto" = the fused kernel (K1 + K2), "xla" = the
    plain expression ``losses.khm_loss``.  Odd p always takes the plain expression,
    as the JAX dispatcher does.  Inputs are upcast to float32 first."""
    X, M = _f32(X), _f32(M)
    if backend == "xla" or p % 2 == 1:
        return khm_loss(X, M, p)
    if backend not in ("pallas", "auto"):
        raise ValueError(f"khm backend {backend!r}")
    return KHMLoss.apply(X.contiguous(), M.contiguous(), p)

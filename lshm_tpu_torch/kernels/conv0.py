"""The 2D AE's first stage alone: elu(conv0(x) + b), k=4, s=2, p=1 (kernel K6).

Replaces ``benchmarks/pallas_conv_probe.py::_kernel`` (through ``conv0_pallas``), the
calibration probe that times one stage of the fused head against the library's own
convolution; ``lshm_tpu_torch/tools/conv0_probe.py`` is the port's probe.  The CUDA
source is ``lshm_tpu_torch/csrc/conv0.cu``; its header comment gives the design.

Layouts: x NHWC [B, P, P, C] (C = 4 or 8), w OIHW [8, C, 4, 4], b [8], output NHWC
[B, P/2, P/2, 8].  ``conv0_elu`` is the kernel wrapper (the CUDA kernel for a CUDA
tensor, ``conv0_elu_plain`` for a CPU tensor).

Bound on the H100 at B=420, P=128, C=4: 165.2 MB moved (49 us at 3.35 TB/s) and
1.76 GFLOP (26 us at 67 TFLOP/s FP32), so it is bound by bytes.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from lshm_tpu_torch.kernels import _build

F0 = 8                             # the ladder's first width
# launches of the CUDA kernel since the last reset (kernels.reset_launches)
launches = {"conv0": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.library("conv0")
    lib.conv0_fwd.argtypes = [_P, _P, _P, _I, _I, _I, _P, _P]
    lib.conv0_fwd.restype = _I
    return lib


def _check(name: str, t: torch.Tensor, shape: tuple, device: torch.device) -> None:
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: the conv0 kernel takes float32, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: the conv0 kernel takes a contiguous tensor")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")


def conv0_elu_plain(x, w, b) -> torch.Tensor:
    """elu(conv0(x) + b) in plain PyTorch, NHWC in and out."""
    y = F.elu(F.conv2d(x.permute(0, 3, 1, 2), w, b, stride=2, padding=1))
    return y.permute(0, 2, 3, 1).contiguous()


def conv0_elu(x, w, b) -> torch.Tensor:
    """K6: elu(conv0(x) + b), NHWC [B, P/2, P/2, 8]."""
    if x.dim() != 4:
        raise ValueError("conv0: x must be NHWC [B, P, P, C]")
    B, P, P2, C = x.shape
    if P != P2 or P % 2 or C not in (4, 8):
        raise ValueError(f"conv0: x {tuple(x.shape)} needs P == W, P even, C in (4, 8)")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"conv0: unsupported device {x.device}")
    _check("x", x, tuple(x.shape), x.device)
    _check("w", w, (F0, C, 4, 4), x.device)
    _check("b", b, (F0,), x.device)
    if x.device.type == "cpu":
        return conv0_elu_plain(x, w, b)
    lib = _lib()
    out = torch.empty((B, P // 2, P // 2, F0), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.check(lib.conv0_fwd(x.data_ptr(), w.data_ptr(), b.data_ptr(), B, P, C,
                                   out.data_ptr(), stream), "conv0_fwd")
    launches["conv0"] += 1
    return out

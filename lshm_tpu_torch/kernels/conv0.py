"""The 2D AE's first stage alone: elu(conv0(x) + b), k=4, s=2, p=1 (kernel K6).

Replaces ``benchmarks/pallas_conv_probe.py::_kernel`` (through ``conv0_pallas``), the
calibration probe that times one stage of the fused head against the library's own
convolution; ``lshm_tpu_torch/tools/conv0_probe.py`` is the port's probe.  The CUDA
source is ``lshm_tpu_torch/csrc/conv0.cu``; its header comment gives the design.

Layouts: x NHWC [B, P, P, C] (C = 4 or 8), w OIHW [8, C, 4, 4], b [8], output NHWC
[B, P/2, P/2, 8].  ``conv0_elu`` is the kernel wrapper (the CUDA kernel for a CUDA
tensor, ``conv0_elu_plain`` for a CPU tensor).

dtypes: float32 or bfloat16, one dtype for x, w and b (the JAX probe casts the packed
weights and the bias to x's dtype).  In bfloat16 it computes the TPU kernel's function:
float32 sums of the exact bf16 products, the bias added and the ELU taken in float32,
the output rounded once to bf16.

The kernel sums on the tensor cores in both dtypes (float32 operands in three exact
bf16 pieces, six piece pairs per product) and takes the ELU in float32 within 0.9 ulp
of expm1.  Bound on the H100 at B=420, P=128, C=4: float32 moves 165.2 MB (49 us at
3.35 TB/s) and does 1.76 GFLOP (26 us at 67 TFLOP/s FP32; 10.7 us on the tensor cores
as six bf16 piece pairs), bfloat16 moves 82.6 MB (24.6 us) and its operations take
1.8 us on the bf16 tensor cores: both are bound by bytes.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from lshm_tpu_torch.kernels import _build

F0 = 8                             # the ladder's first width
# launches of the CUDA kernel since the last reset (kernels.reset_launches); the
# bfloat16 form counts apart
launches = {"conv0": 0, "conv0_bf16": 0}
DTYPES = (torch.float32, torch.bfloat16)

_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.library("conv0")
    lib.conv0_fwd.argtypes = [_P, _P, _P, _I, _I, _I, _I, _P, _P]
    lib.conv0_fwd.restype = _I
    return lib


def _check(name: str, t: torch.Tensor, shape: tuple, device: torch.device,
           dtype: torch.dtype) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: the conv0 kernel takes {dtype} here (x's dtype), "
                        f"got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: the conv0 kernel takes a contiguous tensor")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")


def conv0_elu_plain(x, w, b) -> torch.Tensor:
    """elu(conv0(x) + b) in plain PyTorch, NHWC in and out.  On bfloat16 inputs: the
    inputs upcast, the convolution and ELU in float32, the output rounded once (not a
    bf16 convolution, which would round the pre-activation before the ELU)."""
    dtype = x.dtype
    x, w, b = (t.float() for t in (x, w, b))
    y = F.elu(F.conv2d(x.permute(0, 3, 1, 2), w, b, stride=2, padding=1))
    return y.permute(0, 2, 3, 1).to(dtype).contiguous()


def conv0_elu(x, w, b) -> torch.Tensor:
    """K6: elu(conv0(x) + b), NHWC [B, P/2, P/2, 8] in x's dtype."""
    if x.dim() != 4:
        raise ValueError("conv0: x must be NHWC [B, P, P, C]")
    B, P, P2, C = x.shape
    if P != P2 or P % 2 or C not in (4, 8):
        raise ValueError(f"conv0: x {tuple(x.shape)} needs P == W, P even, C in (4, 8)")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"conv0: unsupported device {x.device}")
    if x.dtype not in DTYPES:
        raise TypeError(f"x: the conv0 kernel takes float32 or bfloat16, got {x.dtype}")
    _check("x", x, tuple(x.shape), x.device, x.dtype)
    _check("w", w, (F0, C, 4, 4), x.device, x.dtype)
    _check("b", b, (F0,), x.device, x.dtype)
    if x.device.type == "cpu":
        return conv0_elu_plain(x, w, b)
    lib = _lib()
    bf16 = x.dtype == torch.bfloat16
    out = torch.empty((B, P // 2, P // 2, F0), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.check(lib.conv0_fwd(x.data_ptr(), w.data_ptr(), b.data_ptr(), B, P, C,
                                   int(bf16), out.data_ptr(), stream), "conv0_fwd")
    launches["conv0_bf16" if bf16 else "conv0"] += 1
    return out

"""Fused 2D-AE encoder head: elu(conv1(elu(conv0(x) + b0)) + b1) (kernels K3 and K4).

Replaces ``lshm_tpu/kernels/conv2d_outer.py``: ``_fwd_kernel`` (K3) and
``_bwd_kernel`` (K4), reached there through ``enc_head``.  Both convolutions are
k=4, s=2, p=1 (the reference encoder's two outermost stages, reference:
src/lofar_models.py:31-34).  The CUDA source is ``lshm_tpu_torch/csrc/conv_head.cu``;
its header comment gives the tiling and the bound.

Layouts: x NHWC [B, P, P, C] (the data layout), weights in PyTorch's OIHW with their
biases, output NHWC [B, P/4, P/4, 12] as in the JAX function.  ``head_forward`` and
``head_weight_grads`` are the kernel wrappers: CUDA kernel for a CUDA tensor, the
plain PyTorch version beside them for a CPU tensor.  The input gradient (the TPU's
``_dx_kernel``, K5) is not ported: on a CUDA tensor ``EncHead`` raises when a caller
needs it.  The 2D AE's input is data, so the training path never does.

Bound on the H100 at B=420, P=128, C=4: forward 3.08 GFLOP (46 us at 67 TFLOP/s
FP32) over 130.7 MB (39 us at 3.35 TB/s), bound by operations; backward 7.5 GFLOP
(112 us), bound by operations.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from lshm_tpu_torch.kernels import _build

F0, F1 = 8, 12                     # the ladder's first two widths
# launches of each CUDA kernel since the last reset (kernels.reset_launches)
launches = {"head_fwd": 0, "head_bwd": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.library("conv_head")
    lib.head_grad_len.argtypes, lib.head_grad_len.restype = [_I], _I
    lib.head_bwd_blocks.argtypes, lib.head_bwd_blocks.restype = [_I, _I], _I
    lib.head_fwd.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _P, _P]
    lib.head_fwd.restype = _I
    lib.head_bwd.argtypes = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P]
    lib.head_bwd.restype = _I
    return lib


def _check(name: str, t: torch.Tensor, shape: tuple, device: torch.device) -> None:
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: the conv-head kernel takes float32, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: the conv-head kernel takes a contiguous tensor")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")


def _check_inputs(x, w0, b0, w1, b1) -> tuple[int, int, int]:
    if x.dim() != 4:
        raise ValueError("enc_head: x must be NHWC [B, P, P, C]")
    B, P, P2, C = x.shape
    if P != P2 or P % 4 or C not in (4, 8):
        raise ValueError(f"enc_head: x {tuple(x.shape)} needs P == W, P % 4 == 0, "
                         "C in (4, 8)")
    _check("x", x, tuple(x.shape), x.device)
    _check("w0", w0, (F0, C, 4, 4), x.device)
    _check("b0", b0, (F0,), x.device)
    _check("w1", w1, (F1, F0, 4, 4), x.device)
    _check("b1", b1, (F1,), x.device)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"enc_head: unsupported device {x.device}")
    return B, P, C


# ------------------------------------------------------------------ plain versions

def enc_head_plain(x, w0, b0, w1, b1) -> torch.Tensor:
    """The head in plain PyTorch: two strided convolutions with ELU, NHWC in and out."""
    h = x.permute(0, 3, 1, 2)
    h = F.elu(F.conv2d(h, w0, b0, stride=2, padding=1))
    h = F.elu(F.conv2d(h, w1, b1, stride=2, padding=1))
    return h.permute(0, 2, 3, 1).contiguous()


def head_grads_plain(x, w0, b0, w1, b1, g1, input_grad: bool = False):
    """Gradients of ``<g1, enc_head_plain(...)>`` w.r.t. (w0, b0, w1, b1) [and x
    first, when ``input_grad``], by autograd through the plain version."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_() for t in (x, w0, b0, w1, b1)]
        y = enc_head_plain(*ins)
        wrt = ins if input_grad else ins[1:]
        return torch.autograd.grad(y, wrt, g1)


# ---------------------------------------------------------------- kernel wrappers

def head_forward(x, w0, b0, w1, b1) -> torch.Tensor:
    """K3: the head's output, NHWC [B, P/4, P/4, 12]."""
    B, P, C = _check_inputs(x, w0, b0, w1, b1)
    if x.device.type == "cpu":
        return enc_head_plain(x, w0, b0, w1, b1)
    lib = _lib()
    out = torch.empty((B, P // 4, P // 4, F1), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.check(lib.head_fwd(x.data_ptr(), w0.data_ptr(), b0.data_ptr(),
                                  w1.data_ptr(), b1.data_ptr(), B, P, C, out.data_ptr(),
                                  stream), "head_fwd")
    launches["head_fwd"] += 1
    return out


def head_weight_grads(x, w0, b0, w1, b1, g1):
    """K4: (dw0, db0, dw1, db1) for the output cotangent g1 (NHWC)."""
    B, P, C = _check_inputs(x, w0, b0, w1, b1)
    _check("g1", g1, (B, P // 4, P // 4, F1), x.device)
    if x.device.type == "cpu":
        return head_grads_plain(x, w0, b0, w1, b1, g1)
    lib = _lib()
    n = lib.head_grad_len(C)
    grads = torch.empty(n, dtype=torch.float32, device=x.device)
    partial = torch.empty((lib.head_bwd_blocks(B, P), n), dtype=torch.float32,
                          device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.check(lib.head_bwd(x.data_ptr(), w0.data_ptr(), b0.data_ptr(),
                                  w1.data_ptr(), b1.data_ptr(), g1.data_ptr(), B, P, C,
                                  partial.data_ptr(), grads.data_ptr(), stream),
                     "head_bwd")
    launches["head_bwd"] += 1
    sizes = (w0.numel(), F0, w1.numel(), F1)
    dw0, db0, dw1, db1 = torch.split(grads, sizes)
    return dw0.view(w0.shape), db0, dw1.view(w1.shape), db1


class EncHead(torch.autograd.Function):
    """The head with a backward that rematerialises both stages (K4)."""

    @staticmethod
    def forward(ctx, x, w0, b0, w1, b1):
        ctx.save_for_backward(x, w0, b0, w1, b1)
        return head_forward(x, w0, b0, w1, b1)

    @staticmethod
    def backward(ctx, g1):
        x, w0, b0, w1, b1 = ctx.saved_tensors
        g1 = g1.contiguous()
        if ctx.needs_input_grad[0]:
            if x.device.type == "cuda":
                raise NotImplementedError(
                    "K5 not ported: the conv head's input gradient "
                    "(lshm_tpu/kernels/conv2d_outer.py::_dx_kernel)")
            return head_grads_plain(x, w0, b0, w1, b1, g1, input_grad=True)
        return (None, *head_weight_grads(x, w0, b0, w1, b1, g1))


def enc_head(x, w0, b0, w1, b1) -> torch.Tensor:
    """elu(conv1(elu(conv0(x) + b0)) + b1) with k=4, s=2, p=1 convolutions; x NHWC,
    weights OIHW; returns NHWC [B, P/4, P/4, 12]."""
    return EncHead.apply(x.contiguous(), w0, b0, w1, b1)

"""Fused 2D-AE encoder head: elu(conv1(elu(conv0(x) + b0)) + b1) (kernels K3, K4, K5).

Replaces ``lshm_tpu/kernels/conv2d_outer.py``: ``_fwd_kernel`` (K3), ``_bwd_kernel``
(K4) and ``_dx_kernel`` (K5), reached there through ``enc_head``.  Both convolutions
are k=4, s=2, p=1 (the reference encoder's two outermost stages, reference:
src/lofar_models.py:31-34).  The CUDA source is ``lshm_tpu_torch/csrc/conv_head.cu``;
its header comment gives the tiling and the bounds.

Layouts: x NHWC [B, P, P, C] (the data layout), weights in PyTorch's OIHW with their
biases, output NHWC [B, P/4, P/4, 12] as in the JAX function.  ``head_forward``,
``head_weight_grads`` and ``head_input_grad`` are the kernel wrappers: CUDA kernel for
a CUDA tensor, the plain PyTorch version beside them for a CPU tensor.  ``EncHead``'s
backward runs K5 only when the caller needs the input's gradient and K4 only when it
needs the weights': the 2D AE's input is data, so training runs K4 alone.

dtypes: K3, K4 and K5 take float32 or bfloat16, one dtype for x, the weights, the
biases and g1 (the bfloat16 compute modes cast all of them, as
``AutoEncoder2D.encode`` does in JAX).  In bfloat16 they compute the TPU kernel's
function: float32 sums of the exact bf16 products, the stage-0 activation rounded to
bf16 between the stages, the output rounded to bf16; K4 returns float32 sums of the
weight gradients, which ``EncHead``'s backward casts to the weights' dtype
(``conv2d_outer.py::_vjp_bwd``); K5 keeps its intermediate dpre1 = g1 * elu'(a1) in
float32 and rounds dx once to x's dtype.

K3 (``tc::head_fwd_tc_kernel``), K4 (``tc::head_bwd_tc_kernel``,
``tc::head_bwd_f32_tc_kernel``) and K5 (``tc::dpre1_tc_kernel`` then
``tc::head_dx_tc_kernel``), each in either dtype, run each per-tile sum as a tensor-core
product (``mma.sync``, bf16 operands, float32 sums); K3 is K4's stage 0 and stage 1 with
the output's epilogue, and K5's first pass the same kernel with the epilogue
g1 * elu'(a1).  In bf16, x, the weights and e0 are exact bf16 operands, and the two
float32 cotangents (dpre1, dpre0) go in as three bf16 pieces each whose sum is the
float32 value exactly, so their sums keep float32 accuracy.  In float32 the kernels split
every operand so (x, w0, w1 and the unrounded e0 too) and run the six piece pairs of
order 2^-16 and above, which come as close to the head in float64 as all nine
(``tests/test_torch_head_bwd_f32_tc.py``, ``tests/test_torch_head_fwd_tc.py``,
``tests/test_torch_head_dx_f32_tc.py``).  The windows stay in shared memory (bf16, or
float32's pieces) and the next tile's loads asynchronously.  The bf16 kernels sum a0
in another order than the plain version, so an e0 near a bf16 tie may round the other
way: K3 bf16's output differs from the plain version's in 1e-4 to 2e-4 of its elements,
by one ulp each; K4's sums lie as far from the head computed in float64 as the plain
float32 version's do, and K5's bf16 dx as far as the plain version's rounded dx
(``chip_smoke.py``).

Bound on the H100 at B=420, P=128, C=4, float32: forward 3.08 GFLOP, float32-accurate
as six bf16 piece pairs on the tensor cores (18.5 GFLOP: 19 us at 989 TFLOP/s; 46 us on
the FP32 units), over 130.7 MB (39 us at 3.35 TB/s), bound by bytes; weight
backward 7.5 GFLOP, each product float32-accurate as six bf16 piece pairs on the
tensor cores (44.9 GFLOP: 45 us at 989 TFLOP/s; 112 us on the FP32 units), bound
by operations (the kernel's products, with the padding, are 68.7 GFLOP: 69 us);
input backward 6.17 GFLOP, float32-accurate as six bf16 piece pairs on the tensor cores
(37 GFLOP: 37 us; 92 us on the FP32 units), over 240.8 MB (72 us), bound by bytes (its
two passes move 392.2 MB, 117 us: x twice, g1, the float32 dpre1 written and read, dx;
their products, with the pairs and the padding, are 79.3 GFLOP, 80 us).  bfloat16:
forward and weight backward each move 65.4 MB (19.5 us), and their operations take 3.1
and 7.6 us on the bf16 tensor cores (989 TFLOP/s), so both are bound by bytes; the
input backward must move 120.4 MB (35.9 us) against 6.2 us of operations, bound by
bytes (its two passes move 216.8 MB: x is read twice, the float32 dpre1 written and
read; their tensor-core products, with the pieces and the padding, are about 25 GFLOP,
26 us).
What binds each kernel on the card, beyond these bounds, is in the CUDA source's header.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from lshm_tpu_torch.kernels import _build

F0, F1 = 8, 12                     # the ladder's first two widths
# launches of each CUDA kernel since the last reset (kernels.reset_launches); the
# bfloat16 forms count apart
launches = {"head_fwd": 0, "head_bwd": 0, "head_dx": 0, "head_fwd_bf16": 0,
            "head_bwd_bf16": 0, "head_dx_bf16": 0}
DTYPES = (torch.float32, torch.bfloat16)

_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.library("conv_head")
    lib.head_grad_len.argtypes, lib.head_grad_len.restype = [_I], _I
    lib.head_bwd_blocks.argtypes, lib.head_bwd_blocks.restype = [_I, _I], _I
    lib.head_fwd.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P]
    lib.head_fwd.restype = _I
    lib.head_bwd.argtypes = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P]
    lib.head_bwd.restype = _I
    lib.head_dx.argtypes = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P]
    lib.head_dx.restype = _I
    return lib


def _check(name: str, t: torch.Tensor, shape: tuple, device: torch.device,
           dtype: torch.dtype) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: the conv-head kernel takes {dtype} here (x's dtype), "
                        f"got {t.dtype}")
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
    if x.dtype not in DTYPES:
        raise TypeError(f"x: the conv-head kernel takes float32 or bfloat16, got {x.dtype}")
    _check("x", x, tuple(x.shape), x.device, x.dtype)
    _check("w0", w0, (F0, C, 4, 4), x.device, x.dtype)
    _check("b0", b0, (F0,), x.device, x.dtype)
    _check("w1", w1, (F1, F0, 4, 4), x.device, x.dtype)
    _check("b1", b1, (F1,), x.device, x.dtype)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"enc_head: unsupported device {x.device}")
    if x.device.type == "cuda" and x.data_ptr() % 16:
        raise ValueError("x: the conv-head kernel loads whole pixels from a 16-byte "
                         "aligned address")
    return B, P, C


# ------------------------------------------------------------------ plain versions

def _head_f32(x, w0, b0, w1, b1, round_e0: bool) -> torch.Tensor:
    """Both stages in float32, NHWC in and out; ``round_e0`` rounds the stage-0
    activation to bf16 with an identity gradient (the TPU kernel's rounding, which
    its backward does not see: it takes elu' of the unrounded a0)."""
    h = F.elu(F.conv2d(x.permute(0, 3, 1, 2), w0, b0, stride=2, padding=1))
    if round_e0:
        h = h + (h.to(torch.bfloat16).float() - h).detach()
    h = F.elu(F.conv2d(h, w1, b1, stride=2, padding=1))
    return h.permute(0, 2, 3, 1)


def enc_head_plain(x, w0, b0, w1, b1) -> torch.Tensor:
    """The head in plain PyTorch: two strided convolutions with ELU, NHWC in and out.
    On bfloat16 inputs it computes the TPU kernel's function: the inputs upcast, both
    convolutions in float32, e0 rounded to bf16 between them, the output rounded to
    bf16 (not bf16 convolutions, which would round a0 before the ELU)."""
    if x.dtype == torch.bfloat16:
        f = [t.float() for t in (x, w0, b0, w1, b1)]
        return _head_f32(*f, round_e0=True).to(torch.bfloat16).contiguous()
    return _head_f32(x, w0, b0, w1, b1, round_e0=False).contiguous()


def head_grads_plain(x, w0, b0, w1, b1, g1, input_grad: bool = False):
    """Gradients of ``<g1, enc_head_plain(...)>`` w.r.t. (w0, b0, w1, b1) [and x
    first, when ``input_grad``], by autograd through the plain version: float32."""
    with torch.enable_grad():
        ins = [t.detach().float().requires_grad_() for t in (x, w0, b0, w1, b1)]
        y = _head_f32(*ins, round_e0=x.dtype == torch.bfloat16)
        wrt = ins if input_grad else ins[1:]
        return torch.autograd.grad(y, wrt, g1.float())


# ---------------------------------------------------------------- kernel wrappers

def head_forward(x, w0, b0, w1, b1) -> torch.Tensor:
    """K3: the head's output, NHWC [B, P/4, P/4, 12]."""
    B, P, C = _check_inputs(x, w0, b0, w1, b1)
    if x.device.type == "cpu":
        return enc_head_plain(x, w0, b0, w1, b1)
    lib = _lib()
    bf16 = x.dtype == torch.bfloat16
    out = torch.empty((B, P // 4, P // 4, F1), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.check(lib.head_fwd(x.data_ptr(), w0.data_ptr(), b0.data_ptr(),
                                  w1.data_ptr(), b1.data_ptr(), B, P, C, int(bf16),
                                  out.data_ptr(), stream), "head_fwd")
    launches["head_fwd_bf16" if bf16 else "head_fwd"] += 1
    return out


def head_weight_grads(x, w0, b0, w1, b1, g1):
    """K4: (dw0, db0, dw1, db1) for the output cotangent g1 (NHWC, x's dtype): float32
    sums in any dtype."""
    B, P, C = _check_inputs(x, w0, b0, w1, b1)
    _check("g1", g1, (B, P // 4, P // 4, F1), x.device, x.dtype)
    if x.device.type == "cpu":
        return head_grads_plain(x, w0, b0, w1, b1, g1)
    if g1.data_ptr() % (2 * g1.element_size()):
        raise ValueError("g1: the weight-gradient kernel loads channel pairs from an "
                         "address aligned to a pair")
    lib = _lib()
    bf16 = x.dtype == torch.bfloat16
    n = lib.head_grad_len(C)
    grads = torch.empty(n, dtype=torch.float32, device=x.device)
    partial = torch.empty((lib.head_bwd_blocks(B, P), n), dtype=torch.float32,
                          device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.check(lib.head_bwd(x.data_ptr(), w0.data_ptr(), b0.data_ptr(),
                                  w1.data_ptr(), b1.data_ptr(), g1.data_ptr(), B, P, C,
                                  int(bf16), partial.data_ptr(), grads.data_ptr(), stream),
                     "head_bwd")
    launches["head_bwd_bf16" if bf16 else "head_bwd"] += 1
    sizes = (w0.numel(), F0, w1.numel(), F1)
    dw0, db0, dw1, db1 = torch.split(grads, sizes)
    return dw0.view(w0.shape), db0, dw1.view(w1.shape), db1


def head_input_grad(x, w0, b0, w1, b1, g1) -> torch.Tensor:
    """K5: dx (NHWC, x's shape and dtype) for the output cotangent g1 (NHWC, x's
    dtype): a float32 sum rounded once."""
    B, P, C = _check_inputs(x, w0, b0, w1, b1)
    _check("g1", g1, (B, P // 4, P // 4, F1), x.device, x.dtype)
    if x.device.type == "cpu":
        return head_grads_plain(x, w0, b0, w1, b1, g1, input_grad=True)[0].to(x.dtype)
    if g1.data_ptr() % (2 * g1.element_size()):
        raise ValueError("g1: the input-gradient kernel loads channel pairs from an "
                         "address aligned to a pair")
    lib = _lib()
    bf16 = x.dtype == torch.bfloat16
    dx = torch.empty_like(x)
    # first pass: g1 * elu'(a1), float32 in either dtype (the TPU kernel's z1 scratch)
    dpre1 = torch.empty(g1.shape, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.check(lib.head_dx(x.data_ptr(), w0.data_ptr(), b0.data_ptr(),
                                 w1.data_ptr(), b1.data_ptr(), g1.data_ptr(), B, P, C,
                                 int(bf16), dpre1.data_ptr(), dx.data_ptr(), stream),
                     "head_dx")
    launches["head_dx_bf16" if bf16 else "head_dx"] += 1
    return dx


@torch.library.custom_op("lshm_tpu_torch::head_fwd", mutates_args=())
def head_fwd_op(x: torch.Tensor, w0: torch.Tensor, b0: torch.Tensor, w1: torch.Tensor,
                b1: torch.Tensor) -> torch.Tensor:
    """K3 as a registered operator, ``torch.ops.lshm_tpu_torch.head_fwd``: its body is
    ``head_forward`` (the kernel for a CUDA tensor, the plain version for a CPU one).
    Tracing (``torch.export``) sees one opaque node and its fake implementation below,
    so an exported program calls K3 where it runs, instead of the trace of whichever
    version ran while it was exported."""
    return head_forward(x, w0, b0, w1, b1)


@head_fwd_op.register_fake
def _(x, w0, b0, w1, b1):
    B, P = x.shape[0], x.shape[1]
    return x.new_empty((B, P // 4, P // 4, F1))


class EncHead(torch.autograd.Function):
    """The head with a backward that rematerialises both stages: K5 for the input's
    gradient, K4 for the weights' (its float32 sums cast to the weights' dtype once,
    as the JAX custom VJP does), each only when asked for.  The forward is the
    registered K3 operator.  Nothing is saved unless a gradient is needed, so the
    head runs on inference tensors too."""

    @staticmethod
    def forward(ctx, x, w0, b0, w1, b1):
        ctx.save_for_backward(x, w0, b0, w1, b1)
        return torch.ops.lshm_tpu_torch.head_fwd(x, w0, b0, w1, b1)

    @staticmethod
    def backward(ctx, g1):
        x, w0, b0, w1, b1 = ctx.saved_tensors
        g1 = g1.contiguous()
        dx = (head_input_grad(x, w0, b0, w1, b1, g1)
              if ctx.needs_input_grad[0] else None)
        dw = (tuple(g.to(w0.dtype) for g in head_weight_grads(x, w0, b0, w1, b1, g1))
              if any(ctx.needs_input_grad[1:]) else (None,) * 4)
        return (dx, *dw)


def enc_head(x, w0, b0, w1, b1) -> torch.Tensor:
    """elu(conv1(elu(conv0(x) + b0)) + b1) with k=4, s=2, p=1 convolutions; x NHWC,
    weights OIHW; returns NHWC [B, P/4, P/4, 12]."""
    return EncHead.apply(x.contiguous(), w0, b0, w1, b1)

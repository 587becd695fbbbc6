"""Bytes and operations of the port's DFT (``lshm_tpu_torch/models/cascade.py::
fft2_shifted``) on NHWC x [B, P, P, C]: six dense matrix products with the orthonormal
P-point DFT matrices, C_h @ x and S_h @ x over [B, P, P*C] (2 x 2 P^3 C a patch), then
C_w and S_w on each of the two over [B*P, P, C] (4 x 2 P^3 C a patch), real | imag
out as [B, P, P, 2C].  The backward to x is the transposed products: the same
operations, the [B, P, P, 2C] cotangent in and [B, P, P, C] out.  ``itemsize`` is x's;
the DFT matrices (4 P^2 numbers, resident) are not counted."""

from __future__ import annotations

from portbench.rooflines import bound_s

# the DFT's kernels in a device trace, matched as substrings of the name in any case:
# any kernel named for the DFT, such as a later hand-written one, and those read on the
# card (H100, torch 2.11, CUDA 12.8) from a profile of the float32 Fourier step at 420
# patches, as the kernels launched under the span ``cascade.dft`` and by the autograd
# nodes its operators made.  cuBLAS's float32 products: C_h and S_h on [N, P, P*C] and
# the backward's transposed ones, then the batched [P, P] @ [P, C] products and theirs;
# no other product of the cascade (the dense layers, the KHM and augmentation losses)
# launches these tile shapes.  torch.roll's kernel, forward and backward, and the cat
# of real | imag over a 3-D view.  Left out, as other operators launch them by the same
# name: the elementwise add and subtract of the products and the negation in the
# subtraction's backward (about 4 % of the DFT's device time).
NAMES = (
    "sm80_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize128x32x8_stage3_warpsize2x2x1_",
    "sm80_xmma_gemm_f32f32_f32f32_f32_nt_n_tilesize128x32x8_stage3_warpsize2x2x1_",
    "sm80_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize128x128x8_stage3_warpsize2x2x1_",
    "sm80_xmma_gemm_f32f32_f32f32_f32_nt_n_tilesize64x128x8_stage3_warpsize1x4x1_",
    "roll_cuda_kernel",
    "CatArrayBatchedCopy_vectorized<at::native::OpaqueType<4u>, unsigned int, 3, ",
    "dft",
)


def spent(kernels: dict) -> tuple[int, float]:
    """(launches, device seconds) of the DFT's kernels in a stretch's ``kernels``
    ({name: [calls, seconds]})."""
    calls, sec = 0, 0.0
    for name, (n, s) in kernels.items():
        if any(k.lower() in name.lower() for k in NAMES):
            calls, sec = calls + n, sec + s
    return calls, sec


def _flops(b: int, p: int, c: int) -> float:
    return 12.0 * b * p ** 3 * c


def fwd(b: int, p: int, c: int, itemsize: int) -> tuple[float, float]:
    """(bytes, flops): x in, real | imag out."""
    return itemsize * (b * p * p * c + b * p * p * 2 * c), _flops(b, p, c)


def bwd(b: int, p: int, c: int, itemsize: int) -> tuple[float, float]:
    """(bytes, flops): the cotangent of real | imag in, x's out."""
    return itemsize * (b * p * p * 2 * c + b * p * p * c), _flops(b, p, c)


def bound(op: str, b: int, p: int, c: int, itemsize: int) -> float:
    return bound_s(*{"fwd": fwd, "bwd": bwd}[op](b, p, c, itemsize))

"""Bytes and operations of the 2D AE's fused encoder head, elu(conv1(elu(conv0(x))))
with k=4, s=2, p=1 convolutions of C -> 8 -> 12 channels, from its shapes (the port's
K3 forward, K4 weight gradients and K5 input gradient, ``lshm_tpu_torch/csrc/
conv_head.cu``).  ``itemsize`` is the compute dtype's: x, the weights, g1 and the
output are in it; K4's gradients are float32."""

from __future__ import annotations

from portbench.rooflines import bound_s

F0, F1, TAPS = 8, 12, 16

# kernel names of each operation in a device trace; K4's fixed-order reduction of its
# partial sums is part of K4
NAMES = {
    "fwd": ("head_fwd_tc_kernel",),
    "bwd": ("head_bwd_tc_kernel", "head_bwd_f32_tc_kernel", "reduce_partials_kernel"),
    "dx": ("dpre1_tc_kernel", "head_dx_tc_kernel"),
}
# the kernel whose launches count the operation's calls
CALLS = {"fwd": "head_fwd_tc_kernel", "bwd": ("head_bwd_tc_kernel", "head_bwd_f32_tc_kernel"),
         "dx": "head_dx_tc_kernel"}


def _convs(b: int, p: int, c: int) -> tuple[float, float]:
    """Multiply-adds x 2 of conv0 and of conv1 over a batch of b patches."""
    a0 = 2.0 * b * (p // 2) ** 2 * F0 * c * TAPS
    a1 = 2.0 * b * (p // 4) ** 2 * F1 * F0 * TAPS
    return a0, a1


def _weights(c: int) -> int:
    return F0 * c * TAPS + F0 + F1 * F0 * TAPS + F1


def fwd(b: int, p: int, c: int, itemsize: int) -> tuple[float, float]:
    """(bytes, flops) of K3: x in, the weights in, the [b, p/4, p/4, 12] output out."""
    a0, a1 = _convs(b, p, c)
    nbytes = itemsize * (b * p * p * c + _weights(c) + b * (p // 4) ** 2 * F1)
    return nbytes, a0 + a1


def bwd(b: int, p: int, c: int, itemsize: int) -> tuple[float, float]:
    """K4: x, g1 and the weights in, the float32 weight gradients out; both stages'
    forward (a0, a1 are not stored), dW1, the stage-0 cotangent and dW0."""
    a0, a1 = _convs(b, p, c)
    nbytes = itemsize * (b * p * p * c + b * (p // 4) ** 2 * F1 + _weights(c)) + 4 * _weights(c)
    return nbytes, 2 * a0 + 3 * a1


def dx(b: int, p: int, c: int, itemsize: int) -> tuple[float, float]:
    """K5: x, g1 and the weights in, dx out; both stages' forward, the stage-0
    cotangent and dx."""
    a0, a1 = _convs(b, p, c)
    nbytes = itemsize * (2 * b * p * p * c + b * (p // 4) ** 2 * F1 + _weights(c))
    return nbytes, 2 * a0 + 2 * a1


def bound(op: str, b: int, p: int, c: int, itemsize: int) -> float:
    return bound_s(*{"fwd": fwd, "bwd": bwd, "dx": dx}[op](b, p, c, itemsize))

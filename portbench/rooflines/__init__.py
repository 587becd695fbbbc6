"""Peaks of the card, and the least time an operation could take on it.

The H100 SXM's published peaks (NVIDIA's data sheet, dense rates): 3.35 TB/s of HBM3
and 989 TFLOP/s on the tensor cores in bf16.  Every share here, in every dtype, is
taken against 989 TFLOP/s: the port computes float32 products on the tensor cores in
bf16 pieces, so a lower float32 peak could be beaten by a correct kernel.  A bound
counts each input byte read once and each output byte written once, and the
operation's arithmetic once, whatever the kernel recomputes.
"""

PEAK_BYTES_S = 3.35e12
PEAK_FLOP_S = 989e12


def bound_s(nbytes: float, flops: float) -> float:
    """The least seconds for moving ``nbytes`` and doing ``flops`` on the card."""
    return max(nbytes / PEAK_BYTES_S, flops / PEAK_FLOP_S)

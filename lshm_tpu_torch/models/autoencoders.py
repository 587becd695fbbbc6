"""Convolutional autoencoders with uv-harmonic positional features (port of
``lshm_tpu/models/autoencoders.py``; reference: src/lofar_models.py:12-184).

Same topology as the JAX modules: 6 stride-2 (2D) or stride-4 (1D) conv stages with the
channel ladder in -> 8 -> 12 -> 24 -> 48 -> 96 -> 192, ELU activations, a 768-wide
bottleneck, a kron-harmonic (sin, cos) uv embedding mixed in through small dense layers,
optional RICA heads, and a mirrored transposed-conv decoder.  The 1D decode always takes
uv (the reference's non-RICA 1D path called decode() without it and crashed,
src/lofar_models.py:150).

Public layouts are the JAX package's (NHWC / NWC in and out); inside, the modules run
PyTorch's NCHW / NCW with weights in PyTorch's layouts, which are the reference's, so
``lshm_tpu_torch.params`` bridges Flax params exactly.  Initialisation draws from
flax's distributions (lecun-normal kernels, zero biases) through an explicit
``torch.Generator``; the bits differ from JAX, the distributions do not.

``dtype`` is the compute dtype (float32 by default, the parameters'), with Flax's ``dtype=``
rule (``lshm_tpu/models/autoencoders.py:352-377``): every conv, transposed conv and
dense layer casts its input, weight and bias to it and returns it, and the ELUs run
in it.  The parameters stay float32; the casts are explicit, not ``torch.autocast``,
which picks dtypes op by op.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from lshm_tpu_torch.kernels import enc_head

CHANNEL_LADDER = (8, 12, 24, 48, 96, 192)
BOTTLENECK = 192 * 2 * 2  # 768


def lecun_normal_(weight: torch.Tensor, fan_in: int,
                  generator: torch.Generator | None) -> None:
    """flax ``lecun_normal``: a normal truncated at 2 std, rescaled so the variance
    is 1 / fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


def init_flax_like_(module: nn.Module, generator: torch.Generator | None) -> None:
    """Re-initialise every conv / transposed conv / linear layer of ``module`` the way
    flax does: lecun-normal weights (fan_in = in_features x kernel taps), zero biases."""
    for m in module.modules():
        if isinstance(m, (nn.Conv1d, nn.Conv2d, nn.Linear)):
            fan_in = m.weight[0].numel()                  # [out, in, *k]
        elif isinstance(m, (nn.ConvTranspose1d, nn.ConvTranspose2d)):
            fan_in = m.weight.shape[0] * m.weight[0, 0].numel()   # [in, out, *k]
        else:
            continue
        lecun_normal_(m.weight, fan_in, generator)
        with torch.no_grad():
            m.bias.zero_()


def uv_harmonic_features(uv: torch.Tensor, scales: Sequence[float]) -> torch.Tensor:
    """Kron-harmonic embedding of (u, v): [N, 2] -> [N, 4 * len(scales)]
    (reference: src/lofar_models.py:60-62)."""
    s = torch.as_tensor(scales, dtype=uv.dtype, device=uv.device)
    k = (s[None, :, None] * uv[:, None, :]).reshape(uv.shape[0], -1)     # [N, 2H]
    return torch.cat([torch.sin(k), torch.cos(k)], dim=-1)              # [N, 4H]


def _run(m: nn.Module, h: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Layer ``m`` on ``h`` with its input, weight and bias cast to the compute
    ``dtype`` and its output in it (the casts do nothing in float32)."""
    h, w, b = h.to(dtype), m.weight.to(dtype), m.bias.to(dtype)
    if isinstance(m, nn.Linear):
        return F.linear(h, w, b)
    if isinstance(m, nn.ConvTranspose1d):
        if h.dtype == torch.bfloat16:
            return _convt1d_taps(m, h, w, b)
        return F.conv_transpose1d(h, w, b, m.stride, m.padding, m.output_padding)
    if isinstance(m, nn.ConvTranspose2d):
        return F.conv_transpose2d(h, w, b, m.stride, m.padding, m.output_padding)
    fn = F.conv1d if isinstance(m, nn.Conv1d) else F.conv2d
    return fn(h, w, b, m.stride, m.padding)


def _convt1d_taps(m: nn.ConvTranspose1d, h: torch.Tensor, w: torch.Tensor,
                  b: torch.Tensor) -> torch.Tensor:
    """The 1D AE's transposed convolution (stride = kernel = 4, no padding) as one
    matrix product: its taps do not overlap, y[n, o, 4 l + k] = sum_c h[n, c, l]
    w[c, o, k] + b[o].  Used in bf16, where PyTorch's CPU conv_transpose1d returns a
    wrong input gradient at [N, 48, 64] -> 24 channels (relative error 1.2 against
    float32, torch 2.13; tests/test_torch_bf16_train.py)."""
    k = w.shape[2]
    assert m.stride == (k,) and m.padding == (0,) and m.output_padding == (0,)
    n, _, L = h.shape
    y = torch.einsum("ncl,cok->nolk", h, w).reshape(n, w.shape[1], L * k)
    return y + b[:, None]


class _AutoEncoder(nn.Module):
    """Shared dense heads of the 2D and 1D autoencoders."""

    def __init__(self, latent_dim: int, channels: int, harmonic_scales: Sequence[float],
                 rica: bool, conv, tconv, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.latent_dim = latent_dim
        self.channels = channels
        self.harmonic_scales = tuple(harmonic_scales)
        self.rica = rica
        hdim = 4 * len(self.harmonic_scales)
        cin = channels
        for i, f in enumerate(CHANNEL_LADDER):
            setattr(self, f"conv{i}", conv(cin, f))
            cin = f
        dec = CHANNEL_LADDER[-2::-1] + (channels,)
        for i, f in enumerate(dec):
            setattr(self, f"tconv{i}", tconv(cin, f))
            cin = f
        self.fcuv1 = nn.Linear(hdim, hdim)
        self.fcuv3 = nn.Linear(hdim, hdim)
        self.fc1 = nn.Linear(BOTTLENECK + hdim, latent_dim)
        self.fc3 = nn.Linear(latent_dim + hdim, BOTTLENECK)
        if rica:
            self.fc2in = nn.Linear(latent_dim, latent_dim)
            self.fc2out = nn.Linear(latent_dim, latent_dim)

    def _layer(self, name: str, h: torch.Tensor) -> torch.Tensor:
        return _run(getattr(self, name), h, self.dtype)

    def _encode_convs(self, h: torch.Tensor, first: int = 0) -> torch.Tensor:
        for i in range(first, len(CHANNEL_LADDER)):
            h = F.elu(self._layer(f"conv{i}", h))
        return h

    def _encode_top(self, h: torch.Tensor, uvf: torch.Tensor) -> torch.Tensor:
        u = F.elu(self._layer("fcuv1", uvf))
        return F.elu(self._layer("fc1", torch.cat([h.reshape(h.shape[0], -1), u], dim=-1)))

    def _decode_bottleneck(self, z: torch.Tensor, uvf: torch.Tensor) -> torch.Tensor:
        u = F.elu(self._layer("fcuv3", uvf))
        return self._layer("fc3", torch.cat([z, u], dim=-1))   # no activation (ref :91)

    def _decode_convs(self, h: torch.Tensor) -> torch.Tensor:
        last = len(CHANNEL_LADDER) - 1
        for i in range(last):
            h = F.elu(self._layer(f"tconv{i}", h))
        return self._layer(f"tconv{last}", h)             # linear output stage

    def forward(self, x: torch.Tensor, uv: torch.Tensor):
        """Returns (reconstruction, latent), both in the JAX package's layout.  With
        RICA the latent is the sparse elu(fc2in(mu)) and decode sees
        elu(fc2out(sparse))."""
        uvf = uv_harmonic_features(uv, self.harmonic_scales)
        mu = self.encode(x, uvf)
        if not self.rica:
            return self.decode(mu, uvf), mu
        mu = F.elu(self._layer("fc2in", mu))
        return self.decode(F.elu(self._layer("fc2out", mu)), uvf), mu


class AutoEncoder2D(_AutoEncoder):
    """2D conv AE on NHWC [N, P, P, C] patches; 6 stride-2 stages reduce P to P/64 = 2.

    ``pallas_head``: run the two outermost encoder stages (conv0 + ELU + conv1 + ELU)
    through the fused kernel (``kernels.enc_head``), on the same parameters; the
    head's input and its four parameters are cast to the compute ``dtype`` first
    (``lshm_tpu/models/autoencoders.py:389-391``)."""

    def __init__(self, latent_dim: int = 224, channels: int = 4,
                 harmonic_scales: Sequence[float] = (1e-4, 1e-3, 1e-2, 1e-1),
                 rica: bool = True, pallas_head: bool = False,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__(
            latent_dim, channels, harmonic_scales, rica,
            conv=lambda i, o: nn.Conv2d(i, o, 4, stride=2, padding=1),
            # torch ConvTranspose2d(4, s=2, p=1): out = 2 * in
            tconv=lambda i, o: nn.ConvTranspose2d(i, o, 4, stride=2, padding=1),
            dtype=dtype,
        )
        self.pallas_head = pallas_head
        init_flax_like_(self, generator)

    def encode(self, x: torch.Tensor, uvf: torch.Tensor) -> torch.Tensor:
        if self.pallas_head:
            c0, c1 = self.conv0, self.conv1
            h = enc_head(*(t.to(self.dtype) for t in (x, c0.weight, c0.bias, c1.weight,
                                                      c1.bias))).permute(0, 3, 1, 2)
            h = self._encode_convs(h, first=2)
        else:
            h = self._encode_convs(x.permute(0, 3, 1, 2))  # NHWC -> NCHW
        return self._encode_top(h, uvf)                    # flatten in (c, h, w) order

    def decode(self, z: torch.Tensor, uvf: torch.Tensor) -> torch.Tensor:
        h = self._decode_bottleneck(z, uvf).reshape(z.shape[0], CHANNEL_LADDER[-1], 2, 2)
        return self._decode_convs(h).permute(0, 2, 3, 1)   # NCHW -> NHWC


class AutoEncoder1D(_AutoEncoder):
    """1D conv AE on the vectorised patch NWC [N, P*P, C]; 6 stride-4 stages reduce
    16384 -> 4 (reference: src/lofar_models.py:103-184)."""

    def __init__(self, latent_dim: int = 16, channels: int = 4,
                 harmonic_scales: Sequence[float] = (1e-4, 1e-3, 1e-2, 1e-1),
                 rica: bool = True, dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__(
            latent_dim, channels, harmonic_scales, rica,
            conv=lambda i, o: nn.Conv1d(i, o, 4, stride=4, padding=1),
            # torch ConvTranspose1d(4, s=4, p=0): out = 4 * in
            tconv=lambda i, o: nn.ConvTranspose1d(i, o, 4, stride=4, padding=0),
            dtype=dtype,
        )
        init_flax_like_(self, generator)

    def encode(self, x: torch.Tensor, uvf: torch.Tensor) -> torch.Tensor:
        h = self._encode_convs(x.permute(0, 2, 1))         # NWC -> NCW
        return self._encode_top(h, uvf)                    # flatten in (c, pos) order

    def decode(self, z: torch.Tensor, uvf: torch.Tensor) -> torch.Tensor:
        h = self._decode_bottleneck(z, uvf).reshape(z.shape[0], CHANNEL_LADDER[-1], 4)
        return self._decode_convs(h).permute(0, 2, 1)      # NCW -> NWC

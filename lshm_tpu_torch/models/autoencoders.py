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

import functools
import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.autograd.function import once_differentiable

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


@functools.cache
def _scales(scales: tuple[float, ...], dtype: torch.dtype,
            device: torch.device) -> torch.Tensor:
    """The harmonic scales as a tensor on ``device``, made once: a copy from the host
    in every forward would synchronise the host with the card, and could not be
    captured in a CUDA graph."""
    with torch.inference_mode(False):
        return torch.as_tensor(scales, dtype=dtype, device=device)


def uv_harmonic_features(uv: torch.Tensor, scales: Sequence[float]) -> torch.Tensor:
    """Kron-harmonic embedding of (u, v): [N, 2] -> [N, 4 * len(scales)]
    (reference: src/lofar_models.py:60-62)."""
    if torch.compiler.is_compiling():
        # a trace (torch.export) takes its own constant: a cached one made under a trace
        # would be a fake tensor, which the next trace cannot lift
        s = torch.as_tensor(tuple(scales), dtype=uv.dtype, device=uv.device)
    else:
        s = _scales(tuple(scales), uv.dtype, uv.device)
    k = (s[None, :, None] * uv[:, None, :]).reshape(uv.shape[0], -1)     # [N, 2H]
    return torch.cat([torch.sin(k), torch.cos(k)], dim=-1)              # [N, 4H]


def _run(m: nn.Module, h: torch.Tensor, dtype: torch.dtype,
         rewrite: bool = False) -> torch.Tensor:
    """Layer ``m`` on ``h`` with its input, weight and bias cast to the compute
    ``dtype`` and its output in it (the casts do nothing in float32).  ``rewrite``
    computes a conv or transposed conv through its exact rewrite (``fast_conv1d`` for
    the 1D layers, ``packed_conv2d`` for the 2D ones), on the same parameters."""
    h, w, b = h.to(dtype), m.weight.to(dtype), m.bias.to(dtype)
    if isinstance(m, nn.Linear):
        return F.linear(h, w, b)
    if isinstance(m, nn.ConvTranspose1d):
        if rewrite or h.dtype == torch.bfloat16:
            return _convt1d_taps(h, w, b)
        return F.conv_transpose1d(h, w, b, m.stride, m.padding, m.output_padding)
    if isinstance(m, nn.ConvTranspose2d):
        if rewrite:
            return convt2d_s2_packed(h, w) + b[:, None, None]
        return F.conv_transpose2d(h, w, b, m.stride, m.padding, m.output_padding)
    if isinstance(m, nn.Conv1d):
        if rewrite:
            return conv1d_s4(h, w) + b[:, None]
        return F.conv1d(h, w, b, m.stride, m.padding)
    if rewrite:
        return conv2d_s2_packed(h, w) + b[:, None, None]
    return F.conv2d(h, w, b, m.stride, m.padding)


def _convt1d_taps(h: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                  groups: int = 1) -> torch.Tensor:
    """The 1D AE's transposed convolution (stride = kernel = 4, no padding) as one
    matrix product per group: its taps do not overlap, y[n, o, 4 l + k] =
    sum_c h[n, c, l] w[c, o, k] + b[o].  It is ``fast_conv1d``'s transposed conv
    (JAX's ``convt1d_s4``), and every bf16 one: PyTorch's CPU conv_transpose1d returns
    a wrong input gradient in bf16 at [N, 48, 64] -> 24 channels (relative error 1.2
    against float32, torch 2.13; tests/test_torch_bf16_train.py)."""
    n, cin, L = h.shape
    o, k = w.shape[1:]
    y = torch.einsum("ngcl,gcok->ngolk", h.reshape(n, groups, cin // groups, L),
                     w.reshape(groups, cin // groups, o, k))
    return y.reshape(n, groups * o, L * k) + b[:, None]


# ------------------------------------------------------------------ exact rewrites
#
# The JAX package's layout rewrites of the strided convolutions (ModelConfig.fuse_1d,
# fast_conv1d and packed_conv2d; lshm_tpu/models/autoencoders.py:100-312, 427-497),
# in PyTorch's NCW / NCHW layouts and weight layouts.  Each computes the same sums as
# the op it replaces, on the same parameters; all are off by default, as in JAX.

def _pack_kernel_s4(w: torch.Tensor) -> torch.Tensor:
    """[F, C, 4] stride-4 kernel -> its [F, 4C, 2] packed-view equivalent: tap d sits
    at position 4j - 1 + d = 4(j + q) + a with (q, a) = divmod(d - 1, 4), packed
    channel a C + c of window tap q + 1."""
    f, c, _ = w.shape
    wp = w.new_zeros((f, 4 * c, 2))
    for d in range(4):
        q, a = divmod(d - 1, 4)
        wp[:, a * c:(a + 1) * c, q + 1] = w[:, :, d]
    return wp


class _Conv1dS4(torch.autograd.Function):
    """Conv1d(k=4, s=4, p=1): the native forward, and the gradients of its packed-view
    equivalent, a k=2, s=1 conv of the [N, 4C, L/4] packed input padded by one cell
    on the left (JAX's ``conv1d_s4`` custom VJP)."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return F.conv1d(x, w, stride=4, padding=1)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        n, c, L = x.shape
        # packed channel a C + c of cell j holds position 4 j + a
        xp = x.reshape(n, c, L // 4, 4).permute(0, 3, 1, 2).reshape(n, 4 * c, L // 4)
        need_x, need_w = ctx.needs_input_grad
        dxp, dwp, _ = torch.ops.aten.convolution_backward(
            g.contiguous(), F.pad(xp, (1, 0)), _pack_kernel_s4(w), None, (1,), (0,),
            (1,), False, (0,), 1, (need_x, need_w, False))
        dx = dw = None
        if need_x:
            dx = dxp[..., 1:].reshape(n, 4, c, L // 4).permute(0, 2, 3, 1).reshape(n, c, L)
        if need_w:
            dw = torch.stack([dwp[:, ((d - 1) % 4) * c:((d - 1) % 4 + 1) * c,
                                  (d - 1) // 4 + 1] for d in range(4)], dim=-1)
        return dx, dw


def conv1d_s4(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Conv1d(k=4, s=4, p=1) of NCW ``x`` with the packed-view backward
    (``model.fast_conv1d``).  The length must be a multiple of 4: the backward packs
    x by four (the forward alone would take any length, but failing here beats a
    forward that works and a backward that does not)."""
    if x.shape[-1] % 4:
        raise ValueError(
            f"conv1d_s4 needs a length divisible by 4 for its packed-view backward; "
            f"got L={x.shape[-1]}")
    return _Conv1dS4.apply(x, w)


def conv2d_s2_packed(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Conv2d(k=4, s=2, p=1) of NCHW ``x`` with OIHW ``w`` by 2x2 space-to-depth
    (``model.packed_conv2d``): with x padded by one, output (i, j) reads padded rows
    2i..2i+3, two 2-row blocks, so it is a k=2, s=1 VALID conv over the packed
    [N, 4C, (H+2)/2, (W+2)/2] view (packed channel (2a + b) C + c) with the same 64
    taps per (c, f)."""
    n, c, h, wd = x.shape
    f = w.shape[0]
    xp = F.pad(x, (1, 1, 1, 1)).reshape(n, c, h // 2 + 1, 2, wd // 2 + 1, 2)
    xp = xp.permute(0, 3, 5, 1, 2, 4).reshape(n, 4 * c, h // 2 + 1, wd // 2 + 1)
    wp = w.reshape(f, c, 2, 2, 2, 2).permute(0, 3, 5, 1, 2, 4).reshape(f, 4 * c, 2, 2)
    return F.conv2d(xp, wp)


def convt2d_s2_packed(z: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """ConvTranspose2d(k=4, s=2, p=1) of NCHW ``z`` with IOHW ``w`` by phase packing
    (``model.packed_conv2d``): output pixel (2i + a, 2j + b) takes kernel rows
    (3 - a, 1 - a) and columns (3 - b, 1 - b) over input rows i - 1 + a + p and
    columns j - 1 + b + q, so one k=2, s=1 VALID conv of z padded by one emits the
    four phases as 4F channels, and a shifted depth-to-space gathers them.  The taps
    are strided views of the flipped kernel: an index list would be copied from the
    host, which a CUDA graph cannot capture."""
    n, c, h, wd = z.shape
    f = w.shape[1]
    rows = [w.flip(2)[:, :, a::2] for a in (0, 1)]            # rows 3 - a, 1 - a
    wy = torch.cat([rows[a].flip(3)[:, :, :, b::2].transpose(0, 1)
                    for a in (0, 1) for b in (0, 1)])          # [4F, C, 2, 2]
    y = F.conv2d(F.pad(z, (1, 1, 1, 1)), wy)                   # [N, 4F, h+1, w+1]
    phase = lambda a, b: y[:, (2 * a + b) * f:(2 * a + b + 1) * f, a:a + h, b:b + wd]
    out = torch.stack([torch.stack([phase(a, 0), phase(a, 1)], dim=-1) for a in (0, 1)],
                      dim=3)                                   # [N, F, h, 2, w, 2]
    return out.reshape(n, f, 2 * h, 2 * wd)


def _grouped(mT: nn.Module, mF: nn.Module, h: torch.Tensor,
             dtype: torch.dtype) -> torch.Tensor:
    """One layer of two parallel 1D convs (or transposed convs) as one grouped op on
    h [N, 2C, L] with channel blocks [T | F]: the weights concatenated on dim 0,
    ``groups=2`` (JAX's ``_grouped_conv1d``)."""
    h = h.to(dtype)
    w = torch.cat([mT.weight, mF.weight]).to(dtype)
    b = torch.cat([mT.bias, mF.bias]).to(dtype)
    if isinstance(mT, nn.Conv1d):
        return F.conv1d(h, w, b, mT.stride, mT.padding, groups=2)
    if h.dtype == torch.bfloat16:
        return _convt1d_taps(h, w, b, groups=2)
    return F.conv_transpose1d(h, w, b, mT.stride, groups=2)


def fused_dual_ae1d(aeT: "AutoEncoder1D", aeF: "AutoEncoder1D", sT: torch.Tensor,
                    sF: torch.Tensor, uvf: torch.Tensor, rica: bool,
                    dtype: torch.dtype = torch.float32):
    """The two 1D AEs (time-major ``aeT`` on ``sT``, freq-major ``aeF`` on ``sF``, NWC
    [N, L, C]) as one grouped-conv stack (``model.fuse_1d``; JAX's
    ``fused_dual_ae1d``): half the conv launches, on the two modules' own parameters,
    so under ``functional_call`` too.  ``uvf`` is the shared uv-harmonic embedding.
    Returns ``((yT, muT), (yF, muF))``, the same as ``aeT(sT)``, ``aeF(sF)``.  The
    strided ops stay native here whatever ``fast_conv1d`` says, as in JAX."""
    n, _, c = sT.shape
    run = lambda ae, name, a: _run(getattr(ae, name), a, dtype)
    h = torch.cat([sT, sF], dim=-1).permute(0, 2, 1)           # NWC -> NCW [T | F]
    for i in range(len(CHANNEL_LADDER)):
        h = F.elu(_grouped(getattr(aeT, f"conv{i}"), getattr(aeF, f"conv{i}"), h, dtype))
    top = CHANNEL_LADDER[-1]

    def latent_and_z(ae, flat):                                # flat in (c, pos) order
        u = F.elu(run(ae, "fcuv1", uvf))
        mu = F.elu(run(ae, "fc1", torch.cat([flat.reshape(n, -1), u], dim=-1)))
        if not rica:
            return mu, mu
        mu = F.elu(run(ae, "fc2in", mu))
        return mu, F.elu(run(ae, "fc2out", mu))

    def bottleneck(ae, z):
        u = F.elu(run(ae, "fcuv3", uvf))
        return run(ae, "fc3", torch.cat([z, u], dim=-1)).reshape(n, top, 4)

    muT, zT = latent_and_z(aeT, h[:, :top])
    muF, zF = latent_and_z(aeF, h[:, top:])
    h = torch.cat([bottleneck(aeT, zT), bottleneck(aeF, zF)], dim=1)
    last = len(CHANNEL_LADDER) - 1
    for i in range(last + 1):
        h = _grouped(getattr(aeT, f"tconv{i}"), getattr(aeF, f"tconv{i}"), h, dtype)
        if i < last:                                           # linear output stage
            h = F.elu(h)
    return (h[:, :c].permute(0, 2, 1), muT), (h[:, c:].permute(0, 2, 1), muF)


class _AutoEncoder(nn.Module):
    """Shared dense heads of the 2D and 1D autoencoders."""

    def __init__(self, latent_dim: int, channels: int, harmonic_scales: Sequence[float],
                 rica: bool, conv, tconv, dtype: torch.dtype = torch.float32,
                 rewritten: frozenset = frozenset()):
        super().__init__()
        self.dtype = dtype
        self.rewritten = rewritten       # names of the layers run through their rewrite
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
        return _run(getattr(self, name), h, self.dtype, name in self.rewritten)

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
    (``lshm_tpu/models/autoencoders.py:389-391``).

    ``packed``: the outermost ``packed`` encoder stages (conv0..) and decoder stages
    (..tconv5) run space-to-depth packed (``conv2d_s2_packed``,
    ``convt2d_s2_packed``).  Under ``pallas_head`` stages 0 and 1 stay in the kernel,
    as in JAX."""

    def __init__(self, latent_dim: int = 224, channels: int = 4,
                 harmonic_scales: Sequence[float] = (1e-4, 1e-3, 1e-2, 1e-1),
                 rica: bool = True, pallas_head: bool = False,
                 dtype: torch.dtype = torch.float32, packed: int = 0,
                 generator: torch.Generator | None = None):
        n = len(CHANNEL_LADDER)
        super().__init__(
            latent_dim, channels, harmonic_scales, rica,
            conv=lambda i, o: nn.Conv2d(i, o, 4, stride=2, padding=1),
            # torch ConvTranspose2d(4, s=2, p=1): out = 2 * in
            tconv=lambda i, o: nn.ConvTranspose2d(i, o, 4, stride=2, padding=1),
            dtype=dtype,
            rewritten=frozenset([f"conv{i}" for i in range(min(packed, n))]
                                + [f"tconv{i}" for i in range(max(n - packed, 0), n)]),
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
    16384 -> 4 (reference: src/lofar_models.py:103-184).  ``fast``: every stride-4
    conv takes ``conv1d_s4`` and every transposed conv ``_convt1d_taps``
    (``model.fast_conv1d``)."""

    def __init__(self, latent_dim: int = 16, channels: int = 4,
                 harmonic_scales: Sequence[float] = (1e-4, 1e-3, 1e-2, 1e-1),
                 rica: bool = True, dtype: torch.dtype = torch.float32,
                 fast: bool = False, generator: torch.Generator | None = None):
        n = len(CHANNEL_LADDER)
        super().__init__(
            latent_dim, channels, harmonic_scales, rica,
            conv=lambda i, o: nn.Conv1d(i, o, 4, stride=4, padding=1),
            # torch ConvTranspose1d(4, s=4, p=0): out = 4 * in
            tconv=lambda i, o: nn.ConvTranspose1d(i, o, 4, stride=4, padding=0),
            dtype=dtype,
            rewritten=frozenset(f"{k}{i}" for k in ("conv", "tconv") for i in range(n))
            if fast else frozenset(),
        )
        init_flax_like_(self, generator)

    def encode(self, x: torch.Tensor, uvf: torch.Tensor) -> torch.Tensor:
        h = self._encode_convs(x.permute(0, 2, 1))         # NWC -> NCW
        return self._encode_top(h, uvf)                    # flatten in (c, pos) order

    def decode(self, z: torch.Tensor, uvf: torch.Tensor) -> torch.Tensor:
        h = self._decode_bottleneck(z, uvf).reshape(z.shape[0], CHANNEL_LADDER[-1], 4)
        return self._decode_convs(h).permute(0, 2, 1)      # NCW -> NWC

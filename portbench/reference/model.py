"""The plain reference of the cascaded autoencoders, their objective and the KHM head.

A functional rewrite, in plain PyTorch, of the published model (reference repository
https://github.com/SarodYatawatta/LSHM, src/lofar_models.py and
src/kharmonic_lofar.py), frozen here as the yardstick: it follows the port's plain
paths at commit 7ff9298 (``lshm_tpu_torch/models/{cascade,autoencoders,khm}.py``,
``lshm_tpu_torch/losses.py``, ``lshm_tpu_torch/train/objective.py``) with the fused
encoder head written as its two strided convolutions and the KHM loss as its plain
expression.  Parameters are a dict keyed like the port's ``state_dict`` (PyTorch
layouts: OIHW conv, IOHW transposed conv, [out, in] dense), so the same tensors feed
both sides.  Nothing here imports the port.

``Precision`` says how the convolutions and dense layers compute, as the
configuration's ``compute_dtype`` states: ``float32`` only so far (TF32 is the
caller's switch); a lower precision goes there.  The objective sums in float32.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

LADDER = (8, 12, 24, 48, 96, 192)
BOTTLENECK = 192 * 4
EPS = 1e-9


@dataclass(frozen=True)
class Shape:
    """The model's widths (the configuration's, ``lshm_tpu_torch.config.ModelConfig``)."""
    latent: int = 224
    latent_1d: int = 16
    channels: int = 4
    clusters: int = 10
    order: int = 4
    scales: tuple = (1e-4, 1e-3, 1e-2, 1e-1)
    rica: bool = True

    @property
    def total_latent(self) -> int:
        return self.latent + 2 * self.latent_1d


def param_spec(s: Shape) -> list[tuple[str, tuple, int]]:
    """(name, shape, fan_in) of every parameter; fan_in 0 marks a bias, -1 the
    centroids."""
    spec = []
    hdim = 4 * len(s.scales)

    def ae(prefix: str, taps: tuple, latent: int):
        cin = s.channels
        k = math.prod(taps)
        for i, f in enumerate(LADDER):
            spec.append((f"{prefix}.conv{i}.weight", (f, cin, *taps), cin * k))
            spec.append((f"{prefix}.conv{i}.bias", (f,), 0))
            cin = f
        for i, f in enumerate(LADDER[-2::-1] + (s.channels,)):
            spec.append((f"{prefix}.tconv{i}.weight", (cin, f, *taps), cin * k))
            spec.append((f"{prefix}.tconv{i}.bias", (f,), 0))
            cin = f
        dense = [("fcuv1", hdim, hdim), ("fcuv3", hdim, hdim),
                 ("fc1", BOTTLENECK + hdim, latent), ("fc3", latent + hdim, BOTTLENECK)]
        if s.rica:
            dense += [("fc2in", latent, latent), ("fc2out", latent, latent)]
        for name, fin, fout in dense:
            spec.append((f"{prefix}.{name}.weight", (fout, fin), fin))
            spec.append((f"{prefix}.{name}.bias", (fout,), 0))

    ae("ae2d", (4, 4), s.latent)
    ae("aeT", (4,), s.latent_1d)
    ae("aeF", (4,), s.latent_1d)
    spec.append(("khm.M", (s.clusters, s.total_latent), -1))
    return spec


class Precision:
    def __init__(self, mode: str = "float32"):
        if mode != "float32":
            raise ValueError(f"the reference computes in float32, not {mode!r}")
        self.mode = mode

    def __call__(self, op, h, w, b, *args):
        return op(h, w, b, *args)


def _dense(p, name, h, q):
    return q(F.linear, h, p[f"{name}.weight"], p[f"{name}.bias"])


def uv_features(uv: torch.Tensor, scales) -> torch.Tensor:
    s = torch.as_tensor(scales, dtype=uv.dtype, device=uv.device)
    k = (s[None, :, None] * uv[:, None, :]).reshape(uv.shape[0], -1)
    return torch.cat([torch.sin(k), torch.cos(k)], dim=-1)


def _tconv1d(h, w, b, stride, padding):
    """ConvTranspose1d with stride = kernel = 4 and no padding, whose taps do not
    overlap: y[n, o, 4l + k] = sum_c h[n, c, l] w[c, o, k] + b[o]."""
    n, _, length = h.shape
    o, k = w.shape[1:]
    return torch.einsum("ncl,cok->nolk", h, w).reshape(n, o, length * k) + b[:, None]


def autoencoder(p: dict, prefix: str, h: torch.Tensor, uvf: torch.Tensor, dims: int,
                s: Shape, q: Precision):
    """One AE on channels-first ``h`` ([N, C, H, W] or [N, C, L]): (reconstruction in
    the same layout, latent)."""
    conv = F.conv2d if dims == 2 else F.conv1d
    tconv = F.conv_transpose2d if dims == 2 else _tconv1d
    stride, tpad = (2, 1) if dims == 2 else (4, 0)
    n = h.shape[0]
    for i in range(len(LADDER)):
        h = F.elu(q(conv, h, p[f"{prefix}.conv{i}.weight"], p[f"{prefix}.conv{i}.bias"],
                    stride, 1))
    u = F.elu(_dense(p, f"{prefix}.fcuv1", uvf, q))
    mu = F.elu(_dense(p, f"{prefix}.fc1", torch.cat([h.reshape(n, -1), u], dim=-1), q))
    z = mu
    if s.rica:
        mu = F.elu(_dense(p, f"{prefix}.fc2in", mu, q))
        z = F.elu(_dense(p, f"{prefix}.fc2out", mu, q))
    u = F.elu(_dense(p, f"{prefix}.fcuv3", uvf, q))
    h = _dense(p, f"{prefix}.fc3", torch.cat([z, u], dim=-1), q)
    h = h.reshape(n, LADDER[-1], *((2, 2) if dims == 2 else (4,)))
    last = len(LADDER) - 1
    for i in range(last + 1):
        h = q(tconv, h, p[f"{prefix}.tconv{i}.weight"], p[f"{prefix}.tconv{i}.bias"],
              stride, tpad)
        if i < last:
            h = F.elu(h)
    return h, mu


def cascade(p: dict, x: torch.Tensor, uv: torch.Tensor, s: Shape,
            q: Precision) -> dict:
    """The cascade on NHWC patches x [N, P, P, C]: the 2D AE, the halved residual, the
    time-major and freq-major 1D AEs on its vectorisations."""
    n, hh, ww, c = x.shape
    uvf = uv_features(uv, s.scales)
    y, mu = autoencoder(p, "ae2d", x.permute(0, 3, 1, 2), uvf, 2, s, q)
    x1 = y.permute(0, 2, 3, 1)
    x11 = (x - x1) * 0.5
    sT = x11.reshape(n, hh * ww, c).permute(0, 2, 1)
    sF = x11.transpose(1, 2).reshape(n, ww * hh, c).permute(0, 2, 1)
    yT, muT = autoencoder(p, "aeT", sT, uvf, 1, s, q)
    yF, muF = autoencoder(p, "aeF", sF, uvf, 1, s, q)
    x2 = yT.permute(0, 2, 1).reshape(n, hh, ww, c)
    x3 = yF.permute(0, 2, 1).reshape(n, ww, hh, c).transpose(1, 2)
    return dict(x1=x1, x11=x11, x2=x2, x3=x3, xrecon=x1 + x2 + x3,
                Mu=torch.cat([mu, muT, muF], dim=-1), latents=(mu, muT, muF))


# ------------------------------------------------------------------ objective

def sq_dists(X: torch.Tensor, M: torch.Tensor) -> torch.Tensor:
    """||x_i - m_k||^2 [N, K], from the differences."""
    return ((X[:, None, :] - M[None, :, :]) ** 2).sum(-1)


def khm_loss(X, M, p: int):
    N, D = X.shape
    K = M.shape[0]
    e = torch.sum(1.0 / (sq_dists(X, M) ** (p // 2) + EPS), dim=-1)
    return torch.sum(K / (e + EPS)) / (N * K * D)


def khm_distances(X, M, p: int):
    """Per-cluster mean ||x - m_k||^p over the rows of X: [K]."""
    return (sq_dists(X, M) ** (p // 2)).mean(0)


def similarity_loss(M):
    K, D = M.shape
    G = M @ M.T
    nrm = torch.sqrt(torch.diagonal(G))
    E = torch.exp(G / (nrm[:, None] * nrm[None, :] + EPS))
    diag = torch.diagonal(E)
    return torch.sum((E.sum(-1) - diag) / (diag + EPS)) / (K * D)


def augmentation_loss(Z, groups: int):
    N, D = Z.shape
    P = N // groups
    G = (Z / (torch.linalg.vector_norm(Z, dim=-1, keepdim=True) + 1e-6)).reshape(groups, P, D)
    S = torch.einsum("bpd,bqd->bpq", G, G)
    mask = torch.triu(torch.ones((P, P), dtype=Z.dtype, device=Z.device), diagonal=1)
    return torch.sum(torch.sum(torch.exp(-S) * mask, dim=(1, 2)) / P) / (groups * P)


def log_cosh(x):
    a = torch.abs(x)
    return a + torch.log1p(torch.exp(-2.0 * a)) - math.log(2.0)


@dataclass(frozen=True)
class Weights:
    alpha: float = 0.01
    beta: float = 0.01
    gamma: float = 0.01
    rho: float = 1.0
    rica_lambda: float = 0.01


def objective(out: dict, M, x, duals, w: Weights, groups: int, s: Shape):
    """(total, {term: value}) of the augmented-Lagrangian objective."""
    numel = x.numel()
    term = lambda y, r: (torch.sum(y * r) + 0.5 * w.rho * torch.sum(r * r)) / numel
    y1, y2, y3 = duals
    m = {
        "loss0": torch.sum((out["xrecon"] - x) ** 2) / numel,
        "loss1": term(y1, x - out["x1"]),
        "loss2": term(y2, out["x11"] - out["x2"]),
        "loss3": term(y3, out["x11"] - out["x3"]),
        "kdist": w.alpha * khm_loss(out["Mu"], M, s.order),
        "sim": w.beta * similarity_loss(M),
        "aug": w.gamma * augmentation_loss(out["Mu"], groups),
    }
    if s.rica:
        m["rica"] = w.rica_lambda * sum(torch.sum(log_cosh(t)) / t.numel()
                                        for t in out["latents"])
    total = sum(m.values())
    m["loss"] = total
    return total, m


def dual_update(out: dict, x, duals, rho: float):
    y1, y2, y3 = duals
    return (y1 + rho * (x - out["x1"]).detach(), y2 + rho * (out["x11"] - out["x2"]).detach(),
            y3 + rho * (out["x11"] - out["x3"]).detach())

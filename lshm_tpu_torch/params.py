"""Weight bridge between the JAX package's Flax param tree and the port's state_dict.

The port stores weights in PyTorch's own layouts, which are also the reference
implementation's: OIHW/OIW convolutions, IOHW/IOW transposed convolutions, ``[out, in]``
Linear weights, and a (c, h, w) bottleneck flatten.  ``from_flax`` and ``to_flax`` are
exact inverses (pure transposes, flips and permutations), on numpy arrays;
``gnn_from_flax`` and ``gnn_to_flax`` are the same for the graph networks
(``lshm_tpu_torch/graph/gnn.py``).

Layout mapping (the one of ``lshm_tpu/utils/torch_import.py``, kept here as a copy so
that the port imports nothing of the JAX package):

- Conv:           flax HWIO kernel = torch OIHW weight.transpose(2, 3, 1, 0)
- ConvTranspose:  flax HWIO kernel = torch IOHW weight.transpose(2, 3, 0, 1) flipped
                  along every spatial axis (flax's conv_transpose does not flip kernels)
- Dense:          flax [in, out] kernel = torch [out, in] weight.T
- Bottleneck:     torch flattens NCHW (c, h, w), flax NHWC (h, w, c): the first 768
                  input rows of fc1 and the 768 output columns of fc3 are permuted.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np

_C_LADDER = (8, 12, 24, 48, 96, 192)
_AE_NDIM = {"ae2d": 2, "aeT": 1, "aeF": 1, "aef": 2}   # aef: the Fourier variant's AE


def _np(v: Any) -> np.ndarray:
    if hasattr(v, "detach"):          # a torch tensor
        v = v.detach().cpu().numpy()
    return np.asarray(v)


def _bottleneck_perm(ndim: int) -> np.ndarray:
    """perm[flax_index] = torch_index for the 768-wide bottleneck flatten."""
    C = _C_LADDER[-1]
    npos = 4
    perm = np.empty(npos * C, np.int64)
    for pos in range(npos):            # 2D: pos = h * 2 + w; 1D: pos = position
        for c in range(C):
            perm[pos * C + c] = c * npos + pos
    return perm


def _conv_to_torch(k: np.ndarray, ndim: int) -> np.ndarray:
    return k.transpose(3, 2, 0, 1) if ndim == 2 else k.transpose(2, 1, 0)


def _conv_to_flax(w: np.ndarray, ndim: int) -> np.ndarray:
    return w.transpose(2, 3, 1, 0) if ndim == 2 else w.transpose(2, 1, 0)


def _tconv_to_torch(k: np.ndarray, ndim: int) -> np.ndarray:
    if ndim == 2:
        return k[::-1, ::-1].transpose(2, 3, 0, 1)
    return k[::-1].transpose(1, 2, 0)


def _tconv_to_flax(w: np.ndarray, ndim: int) -> np.ndarray:
    if ndim == 2:
        return w.transpose(2, 3, 0, 1)[::-1, ::-1]
    return w.transpose(2, 0, 1)[::-1]


def _ae_from_flax(p: Mapping, prefix: str, ndim: int, out: dict) -> None:
    perm = _bottleneck_perm(ndim)
    for i in range(len(_C_LADDER)):
        out[f"{prefix}.conv{i}.weight"] = _conv_to_torch(_np(p[f"conv{i}"]["kernel"]), ndim)
        out[f"{prefix}.conv{i}.bias"] = _np(p[f"conv{i}"]["bias"])
        out[f"{prefix}.tconv{i}.weight"] = _tconv_to_torch(
            _np(p[f"tconv{i}"]["kernel"]), ndim)
        out[f"{prefix}.tconv{i}.bias"] = _np(p[f"tconv{i}"]["bias"])
    for name in ("fcuv1", "fcuv3", "fc2in", "fc2out"):
        if name in p:
            out[f"{prefix}.{name}.weight"] = _np(p[name]["kernel"]).T
            out[f"{prefix}.{name}.bias"] = _np(p[name]["bias"])
    k1 = _np(p["fc1"]["kernel"])                     # [768 + harmonic, L]
    t1 = k1.copy()
    t1[perm] = k1[: len(perm)]
    out[f"{prefix}.fc1.weight"] = t1.T
    out[f"{prefix}.fc1.bias"] = _np(p["fc1"]["bias"])
    k3, b3 = _np(p["fc3"]["kernel"]), _np(p["fc3"]["bias"])   # [L + harmonic, 768]
    t3, tb3 = np.empty_like(k3), np.empty_like(b3)
    t3[:, perm], tb3[perm] = k3, b3
    out[f"{prefix}.fc3.weight"] = t3.T
    out[f"{prefix}.fc3.bias"] = tb3


def _ae_to_flax(sd: Mapping, prefix: str, ndim: int) -> dict:
    perm = _bottleneck_perm(ndim)
    g = lambda name: _np(sd[f"{prefix}.{name}"])
    out: dict = {}
    for i in range(len(_C_LADDER)):
        out[f"conv{i}"] = {"kernel": _conv_to_flax(g(f"conv{i}.weight"), ndim),
                           "bias": g(f"conv{i}.bias")}
        out[f"tconv{i}"] = {"kernel": _tconv_to_flax(g(f"tconv{i}.weight"), ndim),
                            "bias": g(f"tconv{i}.bias")}
    for name in ("fcuv1", "fcuv3", "fc2in", "fc2out"):
        if f"{prefix}.{name}.weight" in sd:
            out[name] = {"kernel": g(f"{name}.weight").T, "bias": g(f"{name}.bias")}
    t1 = g("fc1.weight").T
    k1 = t1.copy()
    k1[: len(perm)] = t1[perm]
    out["fc1"] = {"kernel": k1, "bias": g("fc1.bias")}
    out["fc3"] = {"kernel": g("fc3.weight").T[:, perm], "bias": g("fc3.bias")[perm]}
    return out


def from_flax(params: Mapping) -> dict[str, np.ndarray]:
    """Flax ``CascadedAE`` params (with or without the outer ``"params"`` key) ->
    the port's ``CascadedAE`` state_dict, as contiguous numpy arrays."""
    p = params["params"] if "params" in params else params
    out: dict[str, np.ndarray] = {}
    for name, ndim in _AE_NDIM.items():
        if name in p:
            _ae_from_flax(p[name], name, ndim, out)
    out["khm.M"] = _np(p["khm"]["M"])
    return {k: np.array(v, order="C") for k, v in out.items()}


def to_flax(state_dict: Mapping) -> dict:
    """The port's ``CascadedAE`` state_dict -> Flax params ``{"params": {...}}``."""
    inner: dict = {}
    for name, ndim in _AE_NDIM.items():
        if f"{name}.fc1.weight" in state_dict:
            inner[name] = _ae_to_flax(state_dict, name, ndim)
    inner["khm"] = {"M": _np(state_dict["khm.M"])}
    return {"params": inner}


# ------------------------------------------------------------------ graph networks
#
# LineGraphNet:    GCNConv_{0,1}/{Dense_0/kernel, bias}  <->  conv{0,1}.{lin.weight, bias}
# StationGraphNet: EdgeConditionedConv_0/Dense_0 .. Dense_{n-1} (the edge MLP's n hidden
#                  layers), Dense_n (W_e), Dense_{n+1} (the root, no bias), bias
#                  <->  conv.edge_mlp.{i}, conv.edge_out, conv.root.weight, conv.bias

def gnn_from_flax(params: Mapping) -> dict[str, np.ndarray]:
    """Flax ``LineGraphNet`` or ``StationGraphNet`` params (with or without the outer
    ``"params"`` key) -> the port's state_dict of the same net, as numpy arrays."""
    p = params["params"] if "params" in params else params
    out: dict[str, np.ndarray] = {}

    def dense(d: Mapping, name: str) -> None:
        out[f"{name}.weight"] = _np(d["kernel"]).T
        if "bias" in d:
            out[f"{name}.bias"] = _np(d["bias"])

    if "GCNConv_0" in p:
        for i in (0, 1):
            dense(p[f"GCNConv_{i}"]["Dense_0"], f"conv{i}.lin")
            out[f"conv{i}.bias"] = _np(p[f"GCNConv_{i}"]["bias"])
    else:
        c = p["EdgeConditionedConv_0"]
        n = sum(k.startswith("Dense_") for k in c) - 2
        for i in range(n):
            dense(c[f"Dense_{i}"], f"conv.edge_mlp.{i}")
        dense(c[f"Dense_{n}"], "conv.edge_out")
        dense(c[f"Dense_{n + 1}"], "conv.root")
        out["conv.bias"] = _np(c["bias"])
    return {k: np.array(v, order="C") for k, v in out.items()}


def gnn_to_flax(state_dict: Mapping) -> dict:
    """The port's ``LineGraphNet`` or ``StationGraphNet`` state_dict -> Flax params
    ``{"params": {...}}``."""
    g = lambda name: _np(state_dict[name])

    def dense(name: str) -> dict:
        d = {"kernel": np.array(g(f"{name}.weight").T, order="C")}
        if f"{name}.bias" in state_dict:
            d["bias"] = g(f"{name}.bias")
        return d

    if "conv0.lin.weight" in state_dict:
        return {"params": {f"GCNConv_{i}": {"Dense_0": dense(f"conv{i}.lin"),
                                            "bias": g(f"conv{i}.bias")} for i in (0, 1)}}
    n = sum(k.startswith("conv.edge_mlp.") and k.endswith(".weight") for k in state_dict)
    c = {f"Dense_{i}": dense(f"conv.edge_mlp.{i}") for i in range(n)}
    c[f"Dense_{n}"] = dense("conv.edge_out")
    c[f"Dense_{n + 1}"] = dense("conv.root")
    c["bias"] = g("conv.bias")
    return {"params": {"EdgeConditionedConv_0": c}}

"""Segment-sum graph neural networks (port of ``lshm_tpu/graph/gnn.py``; reference:
src/train_graph.py:187-196 GCNConv stack; src/train_graph_stat.py:140-152 NNConv with an
MLP edge network).

Message passing is a gather, a matrix product and a segment sum over the destination
nodes (``Tensor.index_add_`` into zeros, JAX's ``jax.ops.segment_sum``), with no
torch_geometric.  No port kernel runs here: JAX computes all of this in XLA, outside any
Pallas kernel.  On CUDA ``index_add_`` sums with float atomics, so two runs may differ
in the last bits; on the CPU they are bit for bit the same.

Weights are in PyTorch's layouts (``[out, in]`` Linear weights); ``lshm_tpu_torch.params``
bridges them with the Flax param trees (``gnn_from_flax``, ``gnn_to_flax``).  Unlike
flax, a torch module takes its input widths when it is built.  Initialisation draws flax
``Dense``'s distributions (lecun-normal kernels, zero biases) from an explicit
``torch.Generator``; the bits differ from JAX, the distributions do not.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from lshm_tpu_torch.models.autoencoders import lecun_normal_


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Row ``s`` of the result sums the rows of ``data`` whose id is ``s``."""
    out = data.new_zeros((num_segments, *data.shape[1:]))
    return out.index_add_(0, segment_ids, data)


def _segment_mean(data: torch.Tensor, segment_ids: torch.Tensor,
                  num_segments: int) -> torch.Tensor:
    tot = segment_sum(data, segment_ids, num_segments)
    cnt = segment_sum(data.new_ones((data.shape[0], 1)), segment_ids, num_segments)
    return tot / torch.clamp(cnt, min=1.0)


def _dense(in_features: int, out_features: int, bias: bool,
           generator: torch.Generator | None) -> nn.Linear:
    """flax ``Dense``: lecun-normal weight over fan-in, zero bias."""
    lin = nn.Linear(in_features, out_features, bias=bias)
    lecun_normal_(lin.weight, in_features, generator)
    if bias:
        with torch.no_grad():
            lin.bias.zero_()
    return lin


class GCNConv(nn.Module):
    """Graph convolution with added self-loops and symmetric D^-1/2 (A+I) D^-1/2
    normalization (the PyG GCNConv semantics used by the reference line-graph net).
    Like JAX's, it adds a loop to every node even where ``edge_index`` already holds
    one, as ``line_graph_edges`` does: such a node's self-weight counts twice."""

    def __init__(self, in_features: int, features: int,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.lin = _dense(in_features, features, False, generator)
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor, edge_index: torch.Tensor) -> torch.Tensor:
        n = x.shape[0]
        loops = torch.arange(n, dtype=edge_index.dtype, device=edge_index.device)
        src = torch.cat([edge_index[0], loops])
        dst = torch.cat([edge_index[1], loops])
        h = self.lin(x)
        deg = segment_sum(torch.ones_like(src, dtype=h.dtype), dst, n)
        dinv = torch.rsqrt(torch.clamp(deg, min=1e-12))
        msg = h[src] * (dinv[src] * dinv[dst])[:, None]
        return segment_sum(msg, dst, n) + self.bias


class EdgeConditionedConv(nn.Module):
    """Edge-conditioned convolution (PyG NNConv semantics, aggr='mean'):
    out_i = x_i W_root + mean_{j->i} x_j . reshape(h(e_ji), [in, out]) + b,
    where h is an MLP on edge features (ELU between its layers)."""

    def __init__(self, in_features: int, edge_features: int, features: int,
                 edge_mlp_hidden: Sequence[int] = (256, 128),
                 generator: torch.Generator | None = None):
        super().__init__()
        self.features = features
        widths = (edge_features, *edge_mlp_hidden)
        self.edge_mlp = nn.ModuleList(_dense(a, b, True, generator)
                                      for a, b in zip(widths, widths[1:]))
        self.edge_out = _dense(widths[-1], in_features * features, True, generator)
        self.root = _dense(in_features, features, False, generator)
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor, edge_index: torch.Tensor,
                edge_attr: torch.Tensor) -> torch.Tensor:
        n, fin = x.shape
        src, dst = edge_index[0], edge_index[1]
        h = edge_attr
        for lin in self.edge_mlp:
            h = F.elu(lin(h))
        W_e = self.edge_out(h).reshape(-1, fin, self.features)   # flax's column order
        msg = torch.bmm(x[src].unsqueeze(1), W_e).squeeze(1)
        agg = _segment_mean(msg, dst, n)
        return self.root(x) + agg + self.bias


class LineGraphNet(nn.Module):
    """Two-layer GCN regressor: node latents -> per-cluster distance labels
    (reference: src/train_graph.py:187-196)."""

    def __init__(self, in_features: int, hidden: int = 4, out_features: int = 10,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.conv0 = GCNConv(in_features, hidden, generator)
        self.conv1 = GCNConv(hidden, out_features, generator)

    def forward(self, x: torch.Tensor, edge_index: torch.Tensor) -> torch.Tensor:
        return self.conv1(F.relu(self.conv0(x, edge_index)), edge_index)


class StationGraphNet(nn.Module):
    """Edge-conditioned station classifier with column softmax
    (reference: src/train_graph_stat.py:140-152)."""

    def __init__(self, in_features: int, edge_features: int, out_features: int = 10,
                 edge_mlp_hidden: Sequence[int] = (256, 128),
                 generator: torch.Generator | None = None):
        super().__init__()
        self.conv = EdgeConditionedConv(in_features, edge_features, out_features,
                                        edge_mlp_hidden, generator)

    def forward(self, x: torch.Tensor, edge_index: torch.Tensor,
                edge_attr: torch.Tensor) -> torch.Tensor:
        # softmax over nodes, as in the reference
        return torch.softmax(self.conv(x, edge_index, edge_attr), dim=0)

"""Graph-classifier training over learned latents (port of ``lshm_tpu/graph/train.py``).

The reference extracts per-baseline latents with a Python loop over baselines and trains
PyG nets full-graph (reference: src/train_graph.py:137-209, src/train_graph_stat.py:161-268).
Here the line graph's features come from the port's ``baseline_distance_matrix`` (the
cascade forward per chunk of 8 baselines, K3 in each, decoded on the card by default)
and the station graph's from the cascade forward per chunk of 16 baselines
(``read_baselines_patches_batch``, the native host decoder where it builds); the GNN
trains full-graph with Adam.

The JAX functions' signatures, with two changes: the cascade and the returned GNN hold
their own weights (no ``params``; the trainers return ``(model, losses)``), and every
entry point takes ``device``, where ``None`` means the card and raises without one.
The trainers also take ``init_state``, a GNN state_dict to start from instead of the
draw from ``seed`` (the weight bridge's entry: ``lshm_tpu_torch.params.gnn_from_flax``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping

import numpy as np
import torch

from lshm_tpu_torch.data.h5io import Source, read_baselines_patches_batch, read_metadata
from lshm_tpu_torch.device import resolve_device
from lshm_tpu_torch.eval.clustering import _model_device, baseline_distance_matrix
from lshm_tpu_torch.graph.build import conjugate_channels, line_graph_edges
from lshm_tpu_torch.graph.gnn import LineGraphNet, StationGraphNet


@dataclass
class GraphData:
    x: np.ndarray                   # [n_nodes, F]
    edge_index: np.ndarray          # [2, E]
    y: np.ndarray                   # [n_nodes, L]
    edge_attr: np.ndarray | None = None
    node_mask: np.ndarray | None = None


def _on(device: torch.device, *arrays: np.ndarray) -> list[torch.Tensor]:
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in arrays]


def _floats(losses: list[torch.Tensor]) -> list[float]:
    """The losses on the host, one synchronisation for the whole run."""
    return torch.stack(losses).tolist() if losses else []


def _adam(model: torch.nn.Module, lr: float) -> torch.optim.Adam:
    """optax.adam's defaults, as ``train/step.py::make_optimizer``."""
    return torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)


def _start(model: torch.nn.Module, init_state: Mapping | None,
           device: torch.device) -> torch.nn.Module:
    if init_state is not None:
        model.load_state_dict({k: torch.as_tensor(v) for k, v in init_state.items()})
    return model.to(device)


def build_line_graph_data(model: torch.nn.Module, source: Source, sap: str,
                          patch_size: int = 128, num_channels: int = 4, order: int = 4,
                          device: str | torch.device | None = None) -> GraphData:
    """Line graph: node features = per-baseline mean latent; labels = per-cluster mean
    distances (reference: src/train_graph.py:120-163)."""
    baselines, _ = read_metadata(source, sap, give_baselines=True)
    X, latents = baseline_distance_matrix(model, source, sap, patch_size, num_channels,
                                          order, device=device)
    edge_index = line_graph_edges(baselines)
    return GraphData(x=latents, edge_index=edge_index, y=X.T.astype(np.float32))


def train_line_graph(data: GraphData, hidden: int = 4, epochs: int = 200, lr: float = 0.01,
                     seed: int = 0, device: str | torch.device | None = None,
                     init_state: Mapping | None = None):
    """Full-graph Adam + MSE training (reference: src/train_graph.py:199-209).
    Returns (model, losses): one loss per epoch, before that epoch's update."""
    device = resolve_device(device)
    x, ei, y = _on(device, data.x, data.edge_index, data.y)
    model = _start(LineGraphNet(x.shape[1], hidden, y.shape[1],
                                generator=torch.Generator().manual_seed(seed)),
                   init_state, device)
    opt = _adam(model, lr)
    losses = []
    for _ in range(epochs):
        opt.zero_grad(set_to_none=True)
        loss = torch.mean((model(x, ei) - y) ** 2)
        loss.backward()
        opt.step()
        losses.append(loss.detach())
    return model, _floats(losses)


def build_station_graph_data(
    model: torch.nn.Module, source: Source, sap: str, stations: dict, baseline_map: dict,
    patch_size: int = 128, num_channels: int = 4, order: int = 4, rng=None,
    device: str | torch.device | None = None,
) -> GraphData:
    """Station graph from one SAP: node features/labels from autocorrelations, edge
    features from cross-correlations in both directions (reverse = conjugate; reference:
    src/train_graph_stat.py:161-258).  One random patch per baseline, as the reference;
    ``rng`` draws them in JAX's order, one draw per baseline, chunk by chunk."""
    device = resolve_device(device)
    _model_device(model, device)
    rng = rng or np.random.default_rng(0)
    baselines, _ = read_metadata(source, sap, give_baselines=True)
    n_stat = len(stations)
    n_edges = len(baseline_map)
    M = model.khm.M.detach().float().cpu().numpy()
    Kc = M.shape[0]

    node_attr = None
    node_labels = None
    node_mask = np.zeros(n_stat, bool)
    edge_attr = None
    edge_used = np.zeros(n_edges, bool)
    edge_index = np.zeros((2, n_edges), np.int64)

    # one read of the source per chunk and one forward per chunk covering both the
    # selected patches and their conjugates, a fixed batch of 2 * len(ids) as in JAX
    chunk_size = 16
    nbase = len(baselines)
    for start in range(0, nbase, chunk_size):
        ids = list(range(start, min(start + chunk_size, nbase)))
        _, _, patches, uv, pairs = read_baselines_patches_batch(
            source, sap, ids, patch_size, num_channels, uvdist=True, give_baselines=True,
        )
        ppb = patches.shape[0] // len(ids)
        sel = np.array([int(rng.integers(0, ppb)) for _ in ids])
        rows = np.arange(len(ids)) * ppb + sel
        xsel, uvsel = patches[rows], uv[rows]
        x, u = _on(device, np.concatenate([xsel, conjugate_channels(xsel)]),
                   np.concatenate([uvsel, uvsel]))
        with torch.inference_mode():
            Mu_all = model(x, u).Mu.float().cpu().numpy()
        Mu_sel = Mu_all[: len(ids)]
        Mu_conj = Mu_all[len(ids):]
        if node_attr is None:
            D = Mu_sel.shape[-1]
            node_attr = np.zeros((n_stat, D), np.float32)
            node_labels = np.zeros((n_stat, Kc), np.float32)
            edge_attr = np.zeros((n_edges, D), np.float32)

        for i in range(len(ids)):
            s1 = int(pairs[i][0])
            s2 = int(pairs[i][1])
            Mu = Mu_sel[i]
            dist = np.array([np.linalg.norm(Mu - M[k]) ** order for k in range(Kc)])
            soft = _softmax(-dist / dist.mean())
            if s1 == s2:
                sid = stations[s1]
                node_mask[sid] = True
                node_attr[sid] = Mu
                node_labels[sid] = soft
            else:
                eid = baseline_map[(s1, s2)]
                edge_index[:, eid] = (stations[s1], stations[s2])
                edge_attr[eid] = Mu
                edge_used[eid] = True
                # reverse direction: conjugated input
                eid2 = baseline_map[(s2, s1)]
                edge_index[:, eid2] = (stations[s2], stations[s1])
                edge_attr[eid2] = Mu_conj[i]
                edge_used[eid2] = True

    keep = np.nonzero(edge_used)[0]           # only the populated edges
    return GraphData(
        x=node_attr, edge_index=edge_index[:, keep], y=node_labels,
        edge_attr=edge_attr[keep], node_mask=node_mask,
    )


def _station_tensors(data: GraphData, device: torch.device) -> list[torch.Tensor]:
    """x, edge_index, edge_attr, y and the node mask as a [n, 1] float column."""
    return _on(device, data.x, data.edge_index, data.edge_attr, data.y,
               data.node_mask.astype(np.float32)[:, None])


def _station_net(x, ea, y, edge_mlp_hidden, seed: int, init_state: Mapping | None,
                 device: torch.device) -> StationGraphNet:
    net = StationGraphNet(x.shape[1], ea.shape[1], y.shape[1], edge_mlp_hidden,
                          generator=torch.Generator().manual_seed(seed))
    return _start(net, init_state, device)


def train_station_graph(
    data: GraphData, epochs: int = 20, lr: float = 0.01, seed: int = 0,
    edge_mlp_hidden=(256, 128), device: str | torch.device | None = None,
    init_state: Mapping | None = None,
):
    """Masked-node MSE training of the edge-conditioned station net
    (reference: src/train_graph_stat.py:262-268).  Returns (model, losses)."""
    device = resolve_device(device)
    x, ei, ea, y, mask = _station_tensors(data, device)
    model = _station_net(x, ea, y, edge_mlp_hidden, seed, init_state, device)
    step = _make_station_step(model, _adam(model, lr))
    losses = [step(x, ei, ea, y, mask) for _ in range(epochs)]
    return model, _floats(losses)


def _make_station_step(model: StationGraphNet, opt: torch.optim.Optimizer):
    """(graph tensors) -> loss before the update: one Adam step of the masked MSE on the
    full graph; the graph may change from call to call (per-epoch rebuilds)."""

    def step(x, ei, ea, y, mask):
        opt.zero_grad(set_to_none=True)
        pred = model(x, ei, ea)
        loss = torch.sum(mask * (pred - y) ** 2) / torch.clamp(torch.sum(mask), min=1.0)
        loss.backward()
        opt.step()
        return loss.detach()

    return step


def train_station_graph_epochs(
    model: torch.nn.Module, files, saps, stations: dict, baseline_map: dict,
    epochs: int = 5, steps_per_graph: int = 20, lr: float = 0.01, seed: int = 0,
    patch_size: int = 128, num_channels: int = 4, order: int = 4,
    edge_mlp_hidden=(256, 128), device: str | torch.device | None = None,
    init_state: Mapping | None = None,
):
    """Per-epoch stochastic graph-rebuild training (reference:
    src/train_graph_stat.py:161-268): every epoch draws a random SAP, rebuilds the
    station graph from ONE random patch per baseline, and keeps training the SAME
    GraphNet with the SAME Adam state across rebuilds.  ``files`` are paths or
    in-memory trees.

    Returns (graph_model, losses) with one loss entry per (epoch, inner step)."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    gmodel = None
    step = None
    losses: list[torch.Tensor] = []
    for _ in range(epochs):
        si = int(rng.integers(0, len(files)))
        data = build_station_graph_data(
            model, files[si], saps[si], stations, baseline_map,
            patch_size, num_channels, order, rng=rng, device=device,
        )
        x, ei, ea, y, mask = _station_tensors(data, device)
        if gmodel is None:
            gmodel = _station_net(x, ea, y, edge_mlp_hidden, seed, init_state, device)
            step = _make_station_step(gmodel, _adam(gmodel, lr))
        losses += [step(x, ei, ea, y, mask) for _ in range(steps_per_graph)]
    return gmodel, _floats(losses)


def _softmax(v):
    e = np.exp(v - v.max())
    return e / e.sum()

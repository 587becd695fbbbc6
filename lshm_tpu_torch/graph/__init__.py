"""Graph networks over learned latents (port of ``lshm_tpu/graph``)."""

from lshm_tpu_torch.graph.build import (
    line_graph_edges,
    station_graph_maps,
    conjugate_channels,
)
from lshm_tpu_torch.graph.gnn import GCNConv, EdgeConditionedConv, LineGraphNet, StationGraphNet
from lshm_tpu_torch.graph.train import (
    GraphData,
    build_line_graph_data,
    build_station_graph_data,
    train_line_graph,
    train_station_graph,
    train_station_graph_epochs,
)
from lshm_tpu_torch.graph.viz import draw_graph

__all__ = [
    "line_graph_edges",
    "station_graph_maps",
    "conjugate_channels",
    "GCNConv",
    "EdgeConditionedConv",
    "LineGraphNet",
    "StationGraphNet",
    "GraphData",
    "build_line_graph_data",
    "build_station_graph_data",
    "train_line_graph",
    "train_station_graph",
    "train_station_graph_epochs",
    "draw_graph",
]

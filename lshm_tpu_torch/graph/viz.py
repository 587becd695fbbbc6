"""Graph-structure visualization (port of ``lshm_tpu/graph/viz.py``).

The reference renders the baseline line graph with networkx before training
(reference: src/train_graph.py:163-185).  Here both graph geometries can be drawn:
nodes colored by their dominant (argmin-distance / argmax-soft) cluster label, station
nodes without autocorrelation features greyed out.  matplotlib and networkx are imported
inside ``draw_graph``.
"""

from __future__ import annotations

import numpy as np


def draw_graph(data, out_path: str, title: str = "", seed: int = 0,
               directed: bool = False, labels_are_distances: bool | None = None) -> str:
    """Render a GraphData object (``lshm_tpu_torch.graph.GraphData``) to a PNG.

    Node colors: when ``y`` holds per-cluster mean distances (line graphs) the
    dominant cluster is the argmin; when it holds soft labels (station graphs) it is
    the argmax.  ``labels_are_distances`` selects explicitly; when None it defaults
    from ``directed`` (station graphs are the directed ones here).  Masked-out
    station nodes (no autocorrelation) are drawn grey.
    """
    from lshm_tpu_torch.utils.rgb import headless_matplotlib

    headless_matplotlib()
    import matplotlib.pyplot as plt
    import networkx as nx

    G = nx.DiGraph() if directed else nx.Graph()
    n = data.x.shape[0]
    G.add_nodes_from(range(n))
    for u, v in data.edge_index.T:
        if int(u) != int(v):               # self-loops clutter the drawing
            G.add_edge(int(u), int(v))

    y = np.asarray(data.y)
    if labels_are_distances is None:
        labels_are_distances = not directed
    if y.ndim == 2 and y.shape[1] > 1:
        # distances: lower = closer (argmin); soft labels: higher = dominant (argmax)
        colors = (np.argmin(y, axis=1) if labels_are_distances
                  else np.argmax(y, axis=1)).astype(float)
    else:
        colors = np.zeros(n)
    if data.node_mask is not None:
        colors = np.where(data.node_mask, colors, np.nan)

    pos = nx.spring_layout(G, seed=seed)
    fig, ax = plt.subplots(figsize=(8, 8))
    cmap = plt.get_cmap("Spectral")
    node_colors = [
        (0.8, 0.8, 0.8, 1.0) if np.isnan(c)
        else cmap(c / max(np.nanmax(colors), 1.0))
        for c in colors
    ]
    nx.draw_networkx_edges(G, pos, ax=ax, alpha=0.3, arrows=directed)
    nx.draw_networkx_nodes(G, pos, ax=ax, node_color=node_colors, node_size=120)
    if n <= 64:
        nx.draw_networkx_labels(G, pos, ax=ax, font_size=7)
    ax.set_title(title or f"{n} nodes, {G.number_of_edges()} edges")
    ax.set_axis_off()
    fig.savefig(out_path, dpi=100, bbox_inches="tight")
    plt.close(fig)
    return out_path

"""Graph construction from interferometer baselines (a copy of
``lshm_tpu/graph/build.py``: pure numpy, kept here so that the port imports nothing of
the JAX package).

Two graph geometries from the reference (SURVEY.md §2):

- **line graph** (reference: src/train_graph.py:89-118): nodes = baselines; for baseline
  (s1, s2), edges to every baseline sharing s1 (self-loop included, as in the reference)
  plus, when s1 != s2, every *other* baseline sharing s2.
- **station graph** (reference: src/train_graph_stat.py:84-138): nodes = stations
  (features from autocorrelation baselines); directed edges = cross-correlation baselines
  in both directions, the reverse direction carrying the complex-conjugated spectrogram
  (imaginary channels negated; reference :224-225).
"""

from __future__ import annotations

import numpy as np


def line_graph_edges(baselines: np.ndarray, dedup: bool = False) -> np.ndarray:
    """baselines [nbase, 2] -> edge_index [2, E] (int64), reference semantics."""
    nbase = len(baselines)
    stations: dict[int, list[int]] = {}
    for nb in range(nbase):
        s1, s2 = int(baselines[nb][0]), int(baselines[nb][1])
        stations.setdefault(s1, [])
        if nb not in stations[s1]:
            stations[s1].append(nb)
        stations.setdefault(s2, [])
        if nb not in stations[s2]:
            stations[s2].append(nb)
    edges = []
    for nb in range(nbase):
        s1, s2 = int(baselines[nb][0]), int(baselines[nb][1])
        for other in stations[s1]:
            edges.append((nb, other))
        if s1 != s2:
            for other in stations[s2]:
                if other != nb:
                    edges.append((nb, other))
    if dedup:
        edges = sorted(set(edges))
    return np.asarray(edges, np.int64).T.reshape(2, -1)


def station_graph_maps(baseline_lists: list[np.ndarray]):
    """Collect unique stations and directed cross-correlation baselines over SAPs.

    Returns (stations: {station_id -> node index}, baseline_map: {(s1, s2) -> edge id}).
    Station ids may be any hashable (ints or bytes station names)."""
    stations: dict = {}
    baseline_map: dict = {}
    for baselines in baseline_lists:
        for b in baselines:
            s1, s2 = _key(b[0]), _key(b[1])
            if s1 not in stations:
                stations[s1] = len(stations)
            if s2 not in stations:
                stations[s2] = len(stations)
            if s1 != s2:
                if (s1, s2) not in baseline_map:
                    baseline_map[(s1, s2)] = len(baseline_map)
                if (s2, s1) not in baseline_map:
                    baseline_map[(s2, s1)] = len(baseline_map)
    return stations, baseline_map


def _key(x):
    return x.item() if hasattr(x, "item") else x


def conjugate_channels(x: np.ndarray) -> np.ndarray:
    """Complex-conjugate a channel-last spectrogram: negate the imaginary channels
    (odd channel indices; reference: src/train_graph_stat.py:224-225)."""
    out = x.copy()
    out[..., 1::2] *= -1.0
    return out

"""The port's graph networks (``lshm_tpu_torch.graph``) against the JAX package's
(``lshm_tpu/graph``), with no cascade: the numpy graph constructors edge for edge, the
dense oracles of ``tests/test_graph.py`` for the port's layers, each layer and net
against JAX's with bridged weights (forward 1e-5, parameter gradients 2e-5, relative to the
largest value: the JAX suite's rule, ``tests/test_models.py:311-322``), the weight
bridge's round trip, both trainers against JAX's from the same initial weights, and
``read_metadata(give_baselines=True)`` against JAX's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lshm_tpu.data import h5io as jh5io
from lshm_tpu.graph import build as jbuild
from lshm_tpu.graph import gnn as jgnn
from lshm_tpu.graph import train as jtrain
from lshm_tpu_torch.data import h5io, synth_extract
from lshm_tpu_torch.graph import (
    EdgeConditionedConv,
    GCNConv,
    GraphData,
    LineGraphNet,
    StationGraphNet,
    build,
    conjugate_channels,
    line_graph_edges,
    station_graph_maps,
    train_line_graph,
    train_station_graph,
)
from lshm_tpu_torch.params import gnn_from_flax, gnn_to_flax

TRAIN_RTOL = 5e-5       # the trainers' losses per epoch against JAX's, relative; measured 7e-6
#                         to 3.0e-5 over four seeds of the graphs below


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b))) / (float(np.max(np.abs(b))) + 1e-30)


def _pairs(nstations: int) -> np.ndarray:
    """Every station pair of a SAP with its autocorrelations, as the extracts list them."""
    return np.array([(i, j) for i in range(nstations) for j in range(i, nstations)])


# ---------------------------------------------------------------- graph construction

@pytest.mark.parametrize("baselines", [
    [[0, 0], [0, 1], [1, 2]],
    [[0, 0], [0, 1], [1, 2], [1, 1]],
    _pairs(6).tolist(),
    _pairs(6)[np.random.default_rng(3).permutation(21)].tolist(),
], ids=["three", "four", "six_stations", "six_shuffled"])
@pytest.mark.parametrize("dedup", [False, True])
def test_line_graph_edges_equal_jax(baselines, dedup):
    bl = np.asarray(baselines)
    got = line_graph_edges(bl, dedup=dedup)
    want = jbuild.line_graph_edges(bl, dedup=dedup)
    assert got.dtype == want.dtype == np.int64
    np.testing.assert_array_equal(got, want)


def test_line_graph_edges_semantics():
    # 3 stations, baselines: (0,0) auto, (0,1), (1,2)
    edges = set(map(tuple, line_graph_edges(np.array([[0, 0], [0, 1], [1, 2]])).T.tolist()))
    assert (0, 0) in edges and (0, 1) in edges
    assert (1, 0) in edges and (1, 2) in edges and (1, 1) in edges
    assert (2, 1) in edges


def test_six_station_sap_edge_for_edge():
    """All 21 pairs of 6 stations: 21 nodes, each baseline's station groups (with its
    self-loop from the station it shares with itself), JAX's edges in JAX's order."""
    bl = _pairs(6)
    ei = line_graph_edges(bl)
    np.testing.assert_array_equal(ei, jbuild.line_graph_edges(bl))
    # an autocorrelation touches the 6 baselines of its station, a cross-correlation
    # the 6 of its first station and the 5 others of its second
    per_node = np.bincount(ei[0], minlength=len(bl))
    np.testing.assert_array_equal(per_node, [6 if s1 == s2 else 11 for s1, s2 in bl])
    assert ei.shape == (2, 6 * 6 + 15 * 11)


@pytest.mark.parametrize("names", [False, True], ids=["ids", "bytes_names"])
def test_station_graph_maps_equal_jax(names):
    """Two SAPs, the second with a station the first lacks; station ids as ints or as
    the bytes names real extracts carry."""
    sap0, sap1 = _pairs(4), _pairs(5)[4:]
    if names:
        sap0, sap1 = (np.array([[f"CS{s:03d}".encode() for s in b] for b in sap])
                      for sap in (sap0, sap1))
    got = station_graph_maps([sap0, sap1])
    want = jbuild.station_graph_maps([sap0, sap1])
    assert got == want
    assert list(got[0].items()) == list(want[0].items())      # the same node order
    assert list(got[1].items()) == list(want[1].items())      # the same edge ids
    assert len(got[0]) == 5 and len(got[1]) == 2 * 10


def test_conjugate_channels():
    x = np.arange(8, dtype=np.float32).reshape(1, 1, 8)
    np.testing.assert_array_equal(conjugate_channels(x)[0, 0], [0, -1, 2, -3, 4, -5, 6, -7])
    np.testing.assert_array_equal(conjugate_channels(x), jbuild.conjugate_channels(x))
    assert build._key(np.int64(3)) == 3 and build._key(b"CS001") == b"CS001"


@pytest.mark.parametrize("source", ["path", "memory"])
@pytest.mark.parametrize("give_baselines", [False, True])
def test_read_metadata_equals_jax(synth_h5, source, give_baselines):
    src = synth_h5 if source == "path" else synth_extract(nstations=4, ntime=192,
                                                          nfreq=192, seed=7)
    got = h5io.read_metadata(src, "0", give_baselines=give_baselines)
    want = jh5io.read_metadata(synth_h5, "0", give_baselines=give_baselines)
    if give_baselines:
        np.testing.assert_array_equal(got[0], want[0])
        assert got[0].shape == (10, 2) and got[1] == want[1]
    else:
        assert got == want == (10, 192, 192, 4, 2)


# ------------------------------------------------------------------ dense oracles

def test_gcnconv_matches_dense_oracle():
    rng = np.random.default_rng(0)
    n, f_in, f_out = 5, 3, 2
    x = rng.normal(size=(n, f_in)).astype(np.float32)
    edges = np.array([[0, 1], [1, 0], [1, 2], [2, 1], [3, 4], [4, 3]]).T
    m = GCNConv(f_in, f_out, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        m.bias.copy_(torch.tensor([0.5, -0.25]))
    got = m(torch.from_numpy(x), torch.from_numpy(edges)).detach().numpy()

    W = m.lin.weight.detach().numpy().T
    b = m.bias.detach().numpy()
    A = np.zeros((n, n), np.float32)
    for s, d in edges.T:
        A[d, s] = 1.0     # message s -> d
    A += np.eye(n, dtype=np.float32)
    Dm = np.diag(1.0 / np.sqrt(A.sum(axis=1)))
    np.testing.assert_allclose(got, Dm @ A @ Dm @ (x @ W) + b, rtol=1e-5, atol=1e-6)


def test_gcnconv_counts_an_existing_self_loop_twice():
    """JAX's double self-loop: a loop already in ``edge_index`` plus the added one give
    the node's own term the weight 2 in A + I (PyG's add_remaining_self_loops would
    give 1)."""
    x = np.random.default_rng(1).normal(size=(3, 2)).astype(np.float32)
    edges = np.array([[0, 0], [0, 1], [1, 0]]).T
    m = GCNConv(2, 2, generator=torch.Generator().manual_seed(1))
    got = m(torch.from_numpy(x), torch.from_numpy(edges)).detach().numpy()
    A = np.array([[2, 1, 0], [1, 1, 0], [0, 0, 1]], np.float32)
    Dm = np.diag(1.0 / np.sqrt(A.sum(axis=1)))
    W = m.lin.weight.detach().numpy().T
    np.testing.assert_allclose(got, Dm @ A @ Dm @ (x @ W), rtol=1e-5, atol=1e-6)


def test_edge_conditioned_conv_mean_aggregation():
    rng = np.random.default_rng(1)
    n, f_in, f_out, fe = 4, 3, 2, 5
    x = torch.from_numpy(rng.normal(size=(n, f_in)).astype(np.float32))
    edges = torch.tensor([[0, 1], [2, 1], [3, 1]]).T               # all into node 1
    ea = torch.from_numpy(rng.normal(size=(3, fe)).astype(np.float32))
    m = EdgeConditionedConv(f_in, fe, f_out, edge_mlp_hidden=(8,),
                            generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        m.bias.copy_(torch.tensor([0.1, -0.2]))
        got = m(x, edges, ea)
        root = m.root(x)
        # nodes with no incoming edges get only root transform + bias
        torch.testing.assert_close(got[[0, 2, 3]], (root + m.bias)[[0, 2, 3]])
        # node 1: the mean of 3 messages x_j . reshape(h(e_j1), [in, out])
        h = torch.nn.functional.elu(m.edge_mlp[0](ea))
        W = m.edge_out(h).reshape(3, f_in, f_out)
        msgs = torch.stack([x[j] @ W[k] for k, j in enumerate((0, 2, 3))])
        torch.testing.assert_close(got[1], root[1] + msgs.mean(0) + m.bias,
                                   rtol=1e-5, atol=1e-6)


def test_gnn_init_is_flax_dense():
    """Lecun-normal weights truncated at two standard deviations, zero biases, drawn
    from the seed alone."""
    net = StationGraphNet(64, 64, 10, (256, 128), generator=torch.Generator().manual_seed(0))
    again = StationGraphNet(64, 64, 10, (256, 128), generator=torch.Generator().manual_seed(0))
    for (name, p), q in zip(net.named_parameters(), again.parameters()):
        assert torch.equal(p, q), name
        if name.endswith("bias"):
            assert not p.any(), name
        else:
            std = 1.0 / np.sqrt(p.shape[1]) / 0.87962566103423978
            assert float(p.detach().abs().max()) <= 2 * std
            assert abs(float(p.detach().std()) / (std * 0.87962566103423978) - 1) < 0.1, name


# ------------------------------------------------------------------ against JAX

def _graph(n=7, e=16, f=6, seed=0):
    """A seeded random directed graph with node and edge features."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, size=e)
    dst = (src + rng.integers(1, n, size=e)) % n          # no self-loops
    return (rng.normal(size=(n, f)).astype(np.float32), np.stack([src, dst]).astype(np.int64),
            rng.normal(size=(e, f)).astype(np.float32))


def _bridge(kind, port_sd):
    """The Flax params of a port layer or net (layers go through a net's bridge)."""
    if kind == "gcn":
        sd = {f"conv{i}.{k}": v for i in (0, 1) for k, v in port_sd.items()}
        return {"params": gnn_to_flax(sd)["params"]["GCNConv_0"]}
    if kind == "ecc":
        sd = {f"conv.{k}": v for k, v in port_sd.items()}
        return {"params": gnn_to_flax(sd)["params"]["EdgeConditionedConv_0"]}
    return gnn_to_flax(port_sd)


def _grads_to_port(kind, grads):
    if kind == "gcn":
        g = gnn_from_flax({"GCNConv_0": grads["params"], "GCNConv_1": grads["params"]})
        return {k[len("conv0."):]: v for k, v in g.items() if k.startswith("conv0.")}
    if kind == "ecc":
        g = gnn_from_flax({"EdgeConditionedConv_0": grads["params"]})
        return {k[len("conv."):]: v for k, v in g.items()}
    return gnn_from_flax(grads)


CASES = {
    "gcn": (lambda f, g: GCNConv(f, 3, generator=g), lambda: jgnn.GCNConv(3), False),
    "ecc": (lambda f, g: EdgeConditionedConv(f, f, 3, (8, 5), generator=g),
            lambda: jgnn.EdgeConditionedConv(3, (8, 5)), True),
    "ecc_no_hidden": (lambda f, g: EdgeConditionedConv(f, f, 3, (), generator=g),
                      lambda: jgnn.EdgeConditionedConv(3, ()), True),
    "line_net": (lambda f, g: LineGraphNet(f, 4, 5, generator=g),
                 lambda: jgnn.LineGraphNet(hidden=4, out_features=5), False),
    "station_net": (lambda f, g: StationGraphNet(f, f, 5, (16, 8), generator=g),
                    lambda: jgnn.StationGraphNet(out_features=5, edge_mlp_hidden=(16, 8)),
                    True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_layer_and_net_match_jax(case):
    """Forward 1e-5 and every parameter gradient 2e-5, from the port's weights bridged
    to Flax, under a seeded cotangent."""
    make, jmake, with_edges = CASES[case]
    kind = case.split("_no_")[0] if case.startswith("ecc") else case
    x, ei, ea = _graph(seed=sum(map(ord, case)))
    port = make(x.shape[1], torch.Generator().manual_seed(5))
    with torch.no_grad():                       # non-zero biases, so they are tested too
        for name, p in port.named_parameters():
            if name.endswith("bias"):
                p.copy_(torch.linspace(-0.5, 0.5, p.numel()))
    jm = jmake()
    params = jax.tree.map(jnp.asarray, _bridge(kind, port.state_dict()))
    args = (x, ei, ea) if with_edges else (x, ei)
    want = jm.apply(params, *map(jnp.asarray, args))
    cot = np.random.default_rng(9).normal(size=want.shape).astype(np.float32)
    jgrads = jax.grad(lambda p: jnp.sum(jm.apply(p, *map(jnp.asarray, args)) * cot))(params)

    got = port(*(torch.from_numpy(a) for a in args))
    (got * torch.from_numpy(cot)).sum().backward()
    assert _rel(got.detach().numpy(), want) < 1e-5
    want_g = _grads_to_port(kind, jgrads)
    assert want_g.keys() == dict(port.named_parameters()).keys()
    largest = max(float(np.abs(g).max()) for g in want_g.values())
    for name, p in port.named_parameters():
        if case == "station_net" and name == "conv.bias":
            # the softmax over nodes ignores a shift of a whole column, so this
            # gradient is zero but for rounding, in both packages
            assert max(np.abs(p.grad.numpy()).max(), np.abs(want_g[name]).max()) < 2e-5 * largest
            continue
        assert _rel(p.grad.numpy(), want_g[name]) < 2e-5, name


@pytest.mark.parametrize("net", ["line", "station", "station_one_hidden"])
def test_gnn_bridge_round_trip(net):
    x, ei, ea = _graph(seed=2)
    key = jax.random.PRNGKey(3)
    if net == "line":
        p = jgnn.LineGraphNet(hidden=4, out_features=5).init(key, x, ei)
        port = LineGraphNet(6, 4, 5)
    else:
        hidden = (16, 8) if net == "station" else (7,)
        p = jgnn.StationGraphNet(out_features=5, edge_mlp_hidden=hidden).init(key, x, ei, ea)
        port = StationGraphNet(6, 6, 5, hidden)
    p = jax.tree.map(np.asarray, p)
    sd = gnn_from_flax(p)
    assert sd.keys() == port.state_dict().keys()
    for k, v in port.state_dict().items():
        assert sd[k].shape == tuple(v.shape), k
    port.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    back = gnn_to_flax(port.state_dict())
    assert jax.tree.structure(back) == jax.tree.structure(p)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(p)):
        np.testing.assert_array_equal(a, b)
    again = gnn_from_flax(gnn_to_flax(sd))
    assert all(np.array_equal(again[k], sd[k]) for k in sd)


def _line_data(seed=0):
    """A seeded line graph of 8 stations (36 baselines) with 12 node features and 4
    distance-like labels."""
    rng = np.random.default_rng(seed)
    bl = _pairs(8)
    return GraphData(x=rng.normal(size=(len(bl), 12)).astype(np.float32),
                     edge_index=line_graph_edges(bl),
                     y=rng.uniform(0.5, 2.0, size=(len(bl), 4)).astype(np.float32))


def _station_data(seed=1):
    """A seeded station graph of 6 stations, one masked out, and its 30 directed edges."""
    rng = np.random.default_rng(seed)
    stations, bmap = station_graph_maps([_pairs(6)])
    ei = np.array([[stations[a], stations[b]] for a, b in bmap]).T
    y = rng.uniform(size=(6, 4)).astype(np.float32)
    return GraphData(x=rng.normal(size=(6, 10)).astype(np.float32), edge_index=ei,
                     y=y / y.sum(axis=0), edge_attr=rng.normal(size=(30, 10)).astype(np.float32),
                     node_mask=np.array([True, True, False, True, True, True]))


def test_train_line_graph_follows_jax():
    """30 Adam epochs from JAX's initial weights (the bridge's entry): the losses per
    epoch, and the final weights."""
    data = _line_data()
    _, jparams, want = jtrain.train_line_graph(data, hidden=4, epochs=30, seed=2)
    init = jgnn.LineGraphNet(hidden=4, out_features=4).init(
        jax.random.PRNGKey(2), jnp.asarray(data.x), jnp.asarray(data.edge_index))
    model, got = train_line_graph(data, hidden=4, epochs=30, seed=2, device="cpu",
                                  init_state=gnn_from_flax(init))
    assert len(got) == 30 and got[-1] < got[0]
    np.testing.assert_allclose(got, want, rtol=TRAIN_RTOL)
    final = gnn_from_flax(jparams)
    for k, v in model.state_dict().items():
        assert _rel(v.numpy(), final[k]) < 1e-4, k


def test_train_station_graph_follows_jax():
    data = _station_data()
    hidden = (16, 8)
    _, _, want = jtrain.train_station_graph(data, epochs=30, seed=4, edge_mlp_hidden=hidden)
    init = jgnn.StationGraphNet(out_features=4, edge_mlp_hidden=hidden).init(
        jax.random.PRNGKey(4), *map(jnp.asarray, (data.x, data.edge_index, data.edge_attr)))
    _, got = train_station_graph(data, epochs=30, seed=4, edge_mlp_hidden=hidden,
                                 device="cpu", init_state=gnn_from_flax(init))
    assert len(got) == 30 and got[-1] < got[0]
    np.testing.assert_allclose(got, want, rtol=TRAIN_RTOL)


def test_trainers_draw_their_start_from_the_seed():
    data = _station_data()
    a = train_station_graph(data, epochs=2, seed=0, edge_mlp_hidden=(8,), device="cpu")[1]
    b = train_station_graph(data, epochs=2, seed=0, edge_mlp_hidden=(8,), device="cpu")[1]
    c = train_station_graph(data, epochs=2, seed=1, edge_mlp_hidden=(8,), device="cpu")[1]
    assert a == b and a != c
    assert train_line_graph(_line_data(), epochs=0, device="cpu")[1] == []


def test_graph_entry_points_need_a_card(monkeypatch):
    """``device=None`` means the card: without one each entry point raises, never moves
    to the CPU behind the caller's back."""
    from lshm_tpu_torch.graph import build_station_graph_data, train_station_graph_epochs
    from lshm_tpu_torch.models import CascadedAE
    from lshm_tpu_torch import config as tc

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = CascadedAE(tc.ModelConfig(latent_dim=16, latent_dim_1d=8, num_clusters=4))
    tree = synth_extract()
    stations, bmap = station_graph_maps([h5io.read_metadata(tree, "0", True)[0]])
    for call in (lambda: train_line_graph(_line_data(), epochs=1),
                 lambda: train_station_graph(_station_data(), epochs=1),
                 lambda: build_station_graph_data(model, tree, "0", stations, bmap),
                 lambda: train_station_graph_epochs(model, [tree], ["0"], stations, bmap)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()

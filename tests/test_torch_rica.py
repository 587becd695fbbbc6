"""RICA dictionary learning of the port (``lshm_tpu_torch/rica.py``) against the JAX
package's (``lshm_tpu/rica.py``), on JAX's planted problem (``tests/test_rica.py``):
the S-solve's closure, three ``fit_minibatch`` calls from JAX's dictionary and JAX's own
initial codes in both ``l1_mode``s, the objective decreasing, the atoms and their PNG,
and ``python -m lshm_tpu_torch.cli rica`` on the CPU.

Tolerances: the closure 1e-5 (value) and 2e-5 (gradient), the JAX suite's; the fitted
dictionary, loss and |dA| those of the L-BFGS tests in float32 (rtol 2e-4, atol 2e-5,
``tests/test_torch_lbfgs.py``): JAX compiles the solve, the port runs it eagerly."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from lshm_tpu import cli as jcli
from lshm_tpu.config import LBFGSConfig as JLBFGSConfig
from lshm_tpu.rica import RICAConfig as JRICAConfig
from lshm_tpu.rica import RICADictionaryLearner as JLearner
from lshm_tpu_torch import cli
from lshm_tpu_torch.config import LBFGSConfig
from lshm_tpu_torch.optim.lbfgs import value_and_grad
from lshm_tpu_torch.rica import RICAConfig, RICADictionaryLearner

L, M, N = 24, 8, 32
FIT = dict(rtol=2e-4, atol=2e-5)


def planted_problem(rng, L=L, M=M, n=N, sparsity=2):
    """tests/test_rica.py's planted dictionary and sparse codes."""
    A_true = rng.normal(size=(L, M)).astype(np.float32)
    A_true /= np.linalg.norm(A_true, axis=0, keepdims=True)
    S = np.zeros((M, n), np.float32)
    for j in range(n):
        idx = rng.choice(M, sparsity, replace=False)
        S[idx, j] = rng.normal(size=sparsity)
    X = A_true @ S + 0.01 * rng.normal(size=(L, n)).astype(np.float32)
    return A_true, S, X.astype(np.float32)


def _pair(l1_mode="entrywise", l1_weight=0.05, max_iter=6, history_size=5):
    """The JAX learner and the port's on the CPU, the port holding JAX's dictionary."""
    kw = dict(input_dim=L, dict_size=M, l1_weight=l1_weight, l1_mode=l1_mode)
    sk = dict(max_iter=max_iter, history_size=history_size, line_search=True,
              batch_mode=True)
    j = JLearner(JRICAConfig(**kw, solver=JLBFGSConfig(**sk)), seed=0)
    t = RICADictionaryLearner(RICAConfig(**kw, solver=LBFGSConfig(**sk)), seed=0,
                              device="cpu")
    t.A = torch.from_numpy(np.array(j.A))
    return j, t


def _jax_s0(i, n=N):
    """JAX's initial code of its i-th fit (``fit_minibatch(X, PRNGKey(i))``)."""
    return jax.random.uniform(jax.random.PRNGKey(i), (M * n,))


@pytest.mark.parametrize("l1_mode", ["entrywise", "induced"])
def test_closure_value_and_gradient_match_jax(l1_mode):
    _, _, X = planted_problem(np.random.default_rng(0))
    j, t = _pair(l1_mode)
    s = np.random.default_rng(1).normal(size=M * N).astype(np.float32)
    want_v, want_g = jax.value_and_grad(j._loss)(jnp.asarray(s), j.A, jnp.asarray(X))
    got_v, got_g = value_and_grad(t._loss)({"s": torch.from_numpy(s)}, t.A,
                                           torch.from_numpy(X))
    np.testing.assert_allclose(float(got_v), float(want_v), rtol=1e-5)
    want_g = np.asarray(want_g)
    assert np.abs(got_g["s"].numpy() - want_g).max() <= 2e-5 * np.abs(want_g).max()


@pytest.mark.parametrize("l1_mode", ["entrywise", "induced"])
def test_three_fits_match_jax(l1_mode):
    """Three minibatches from JAX's dictionary, each from JAX's own initial code: loss,
    |dA| and the updated dictionary at float32 L-BFGS tolerances."""
    rng = np.random.default_rng(0)
    j, t = _pair(l1_mode)
    for i in range(3):
        _, _, X = planted_problem(rng)
        want = j.fit_minibatch(X, jax.random.PRNGKey(i))
        got = t.fit_minibatch(X, s0=np.array(_jax_s0(i)))
        np.testing.assert_allclose(got["loss"], want["loss"], **FIT)
        np.testing.assert_allclose(got["dA_norm"], want["dA_norm"], **FIT)
        np.testing.assert_allclose(t.A.numpy(), np.asarray(j.A), **FIT)
        st = t.solver_state
        assert 1 <= st.func_evals and st.n_iter <= 6 and st.host_syncs > 0


def test_rica_objective_decreases():
    """tests/test_rica.py:23-37 on the same draws: JAX's initial codes
    (``PRNGKey(i)``), from JAX's dictionary.  The last fits end below the first, as in
    JAX, whose losses the port follows within the float32 tolerance.  (Whether they do
    depends on the draw, in JAX as in the port: the reported loss is the objective at
    the minibatch's initial code, which is uniform noise.)"""
    _, _, X = planted_problem(np.random.default_rng(0))
    j, t = _pair()
    losses = [t.fit_minibatch(X, s0=np.array(_jax_s0(i)))["loss"] for i in range(8)]
    want = [j.fit_minibatch(X, jax.random.PRNGKey(i))["loss"] for i in range(8)]
    assert np.isfinite(losses).all()
    np.testing.assert_allclose(losses, want, **FIT)
    assert min(losses[-3:]) < losses[0]        # reconstruction improves as A adapts


def test_induced_mode_and_seeded_draws():
    """The induced-norm mode runs; the dictionary and the initial codes come from the
    seed and the generator, so two learners agree bit for bit."""
    _, _, X = planted_problem(np.random.default_rng(1))
    cfg = RICAConfig(input_dim=L, dict_size=M, l1_mode="induced",
                     solver=LBFGSConfig(max_iter=3, history_size=3, line_search=True,
                                        batch_mode=True))
    a, b = (RICADictionaryLearner(cfg, seed=3, device="cpu") for _ in range(2))
    assert torch.equal(a.A, b.A) and float(a.A.min()) >= 0 and float(a.A.max()) < 1
    ma = a.fit_minibatch(X, torch.Generator().manual_seed(5))
    mb = b.fit_minibatch(X, torch.Generator().manual_seed(5))
    assert ma == mb and np.isfinite(ma["loss"])
    assert torch.equal(a.A, b.A)
    with pytest.raises(ValueError, match="generator"):
        a.fit_minibatch(X)
    with pytest.raises(ValueError, match="l1_mode"):
        RICAConfig(input_dim=L, l1_mode="entrywize")


def test_the_learner_needs_a_card_or_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RICADictionaryLearner(RICAConfig(input_dim=L, dict_size=M))


def test_columns_atoms_and_png_equal_jax(tmp_path):
    """patches_to_columns and atoms equal JAX's exactly, and from the same dictionary
    the PNG grid is JAX's pixel for pixel (tests/test_rica.py:67-84)."""
    rng = np.random.default_rng(2)
    patches = rng.normal(size=(6, 8, 8, 4)).astype(np.float32)
    got = RICADictionaryLearner.patches_to_columns(patches)
    np.testing.assert_array_equal(got, JLearner.patches_to_columns(patches))
    assert got.shape == (4 * 64, 6)
    np.testing.assert_array_equal(got[64], patches[:, 0, 0, 1])   # second channel block

    j = JLearner(JRICAConfig(input_dim=256, dict_size=4), seed=0)
    t = RICADictionaryLearner(RICAConfig(input_dim=256, dict_size=4), seed=0, device="cpu")
    t.A = torch.from_numpy(np.array(j.A))
    np.testing.assert_array_equal(t.atoms(channels=4, patch=8), j.atoms(channels=4, patch=8))
    assert t.atoms(channels=4, patch=8).shape == (4, 8, 8, 4)
    j.save_atom_images(str(tmp_path / "jax"), channels=4, patch=8)
    t.save_atom_images(str(tmp_path / "port"), channels=4, patch=8)
    want, got = (np.asarray(Image.open(tmp_path / d / "dictionary_atoms.png"))
                 for d in ("jax", "port"))
    np.testing.assert_array_equal(got, want)


RICA_ARGV = ["--iters", "2", "--batch", "2", "--patch-size", "32", "--dict-size", "4",
             "--solver-iters", "2"]                        # tests/test_rica.py:50-64


def test_cli_rica_prints_jax_lines(synth_h5_dir, tmp_path, capsys, monkeypatch):
    """``rica`` of the port's CLI on the CPU with JAX's small flags: JAX's printed lines
    (the numbers differ: the two draw their initial codes from other generators), the
    atom grid of the same size as JAX's."""
    monkeypatch.setenv("LSHM_PLATFORM", "cpu")
    pattern = re.compile(r"rica [01] loss \S+ \|dA\| \S+|wrote (\S+) \(4 atoms\)")
    sizes = []
    for main, name in ((jcli.main, "jax"), (cli.main, "port")):
        out = tmp_path / name
        main(["rica", "--data-dir", synth_h5_dir, "--out", str(out), *RICA_ARGV])
        lines = capsys.readouterr().out.strip().splitlines()
        assert [pattern.fullmatch(line) is not None for line in lines] == [True] * 3, lines
        assert lines[0].startswith("rica 0 loss ") and lines[1].startswith("rica 1 loss ")
        assert pattern.fullmatch(lines[2])[1] == str(out / "dictionary_atoms.png")
        assert all(np.isfinite(float(x)) for x in re.findall(r"[-+]?\d\.\d+e[-+]\d+",
                                                             "".join(lines[:2])))
        sizes.append(Image.open(out / "dictionary_atoms.png").size)
    assert sizes[0] == sizes[1]


def test_cli_rica_without_data_exits(tmp_path, monkeypatch):
    monkeypatch.setenv("LSHM_PLATFORM", "cpu")
    with pytest.raises(SystemExit, match="no valid H5 data"):
        cli.main(["rica", "--data-dir", str(tmp_path), "--out", str(tmp_path / "o")])

"""RICA linear dictionary learning on flattened spectrogram patches (port of
``lshm_tpu/rica.py``; reference: src/rica_lofar.py:44-104): alternate (a) solving the
sparse code S of a minibatch X = A S by the stochastic L-BFGS (``optim/lbfgs.py``) and
(b) a dictionary ascent A += eta * E S^T / n, one matrix product where the reference
loops over outer products (:92-94).

Sparsity: the reference writes ``torch.linalg.norm(S, 1)`` (:80), which for a matrix is
the induced 1-norm (the largest column sum of |S|), almost certainly meant as the
entrywise L1.  The default is the entrywise L1; ``l1_mode="induced"`` is the
reference's formula.

The products run in float32 on the learner's device, TF32 off on the card
(``use_exact_float32``).  The L-BFGS reads its branch predicates on the host
(``LBFGSState.host_syncs``, kept after each solve in ``solver_state``).  ``A`` is drawn
uniform in [0, 1) from a ``torch.Generator`` seeded with ``seed``, and each initial
code from the generator passed to ``fit_minibatch``; the JAX package draws both with
``jax.random``, which torch does not reproduce.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

from lshm_tpu_torch.config import LBFGSConfig
from lshm_tpu_torch.device import resolve_device, use_exact_float32
from lshm_tpu_torch.optim.lbfgs import (LBFGSState, lbfgs_init, make_lbfgs_step,
                                        value_and_grad)


@dataclass
class RICAConfig:
    input_dim: int                    # L = channels * patch * patch
    dict_size: int = 256              # M hidden atoms
    l1_weight: float = 0.1            # lambda1
    dict_lr: float = 0.1              # eta
    l1_mode: str = "entrywise"        # "entrywise" | "induced" (the reference's formula)
    solver: LBFGSConfig = None        # the S-solver's settings

    def __post_init__(self):
        if self.l1_mode not in ("entrywise", "induced"):
            raise ValueError("l1_mode must be 'entrywise' or 'induced', "
                             f"got {self.l1_mode!r}")
        if self.solver is None:
            self.solver = LBFGSConfig(
                lr=1.0, max_iter=10, history_size=7, line_search=True, batch_mode=True
            )


class RICADictionaryLearner:
    """The dictionary ``A`` [input_dim, dict_size] float32 on ``device`` (the card
    unless the caller passes ``"cpu"``)."""

    def __init__(self, cfg: RICAConfig, seed: int = 0,
                 device: str | torch.device | None = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            use_exact_float32()
        gen = torch.Generator().manual_seed(seed)
        self.A = torch.rand((cfg.input_dim, cfg.dict_size), generator=gen).to(self.device)
        self.solver_state: LBFGSState | None = None   # the last solve's, after fit_minibatch
        self._step_cache = {}

    def _loss(self, x: dict, A: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
        """The S-solve's objective of the flat code ``x["s"]`` [dict_size * n]."""
        cfg = self.cfg
        n = X.shape[1]
        S = x["s"].reshape(cfg.dict_size, n)
        E = X - A @ S
        recon = torch.sum(E * E) / (n * cfg.input_dim)
        if cfg.l1_mode == "entrywise":
            l1 = torch.sum(torch.abs(S)) / S.numel()
        else:  # induced matrix 1-norm, the reference's literal formula
            l1 = torch.amax(torch.sum(torch.abs(S), dim=0)) / S.numel()
        return recon + cfg.l1_weight * l1

    def _get_solver(self, n: int):
        if n not in self._step_cache:
            cfg = self.cfg
            lbfgs = make_lbfgs_step(value_and_grad(self._loss), self._loss, cfg.solver)

            def solve_and_update(A, X, s0, opt_state):
                res = lbfgs({"s": s0}, opt_state, A, X)
                with torch.no_grad():
                    S = res.x["s"].reshape(cfg.dict_size, n)
                    E = X - A @ S
                    dA = E @ S.T / n                 # the dictionary gradient, one product
                    A_new = A + cfg.dict_lr * dA
                return A_new, res.loss, torch.linalg.norm(dA), res.state

            self._step_cache[n] = solve_and_update
        return self._step_cache[n]

    def fit_minibatch(self, X, generator: torch.Generator | None = None,
                      s0=None) -> dict:
        """One S-solve and one dictionary update on X [input_dim, n] (columns are
        samples, numpy or a tensor).  The initial code ``s0`` [dict_size * n] is drawn
        uniform in [0, 1) from ``generator`` unless it is given.  Returns
        {loss, dA_norm}; the solver's state stays in ``solver_state``."""
        X = torch.as_tensor(X, dtype=torch.float32).to(self.device)
        n = X.shape[1]
        if s0 is None:
            if generator is None:
                raise ValueError("fit_minibatch needs a generator or an initial code s0")
            s0 = torch.rand((self.cfg.dict_size * n,), generator=generator,
                            device=generator.device)
        s0 = torch.as_tensor(s0, dtype=torch.float32).to(self.device)
        opt_state = lbfgs_init({"s": s0}, self.cfg.solver)
        self.A, loss, dA, self.solver_state = self._get_solver(n)(self.A, X, s0, opt_state)
        return {"loss": float(loss), "dA_norm": float(dA)}

    def atoms(self, channels: int, patch: int) -> np.ndarray:
        """Dictionary columns reshaped to [M, patch, patch, channels] for rendering
        (reference saves them as PNGs: src/rica_lofar.py:101-104)."""
        A = self.A.cpu().numpy()
        return A.T.reshape(self.cfg.dict_size, channels, patch, patch).transpose(0, 2, 3, 1)

    @staticmethod
    def patches_to_columns(patches: np.ndarray) -> np.ndarray:
        """[n, ps, ps, C] NHWC patches -> [C*ps*ps, n] column-major samples with (c, h, w)
        row ordering (matching ``atoms()`` and the reference's NCHW flatten)."""
        n = patches.shape[0]
        return patches.transpose(0, 3, 1, 2).reshape(n, -1).T.copy()

    def save_atom_images(self, out_dir: str, channels: int = 4, patch: int = 128) -> None:
        """The atoms as one PNG grid, ``out_dir/dictionary_atoms.png`` (needs PIL)."""
        from lshm_tpu_torch.utils.rgb import channel_to_rgb, save_image_grid

        os.makedirs(out_dir, exist_ok=True)
        imgs = [channel_to_rgb(a[..., :4]) for a in self.atoms(channels, patch)]
        save_image_grid(imgs, os.path.join(out_dir, "dictionary_atoms.png"))

"""Stochastic L-BFGS with line search (port of ``lshm_tpu/optim/lbfgs.py``; reference:
src/lbfgsnew.py:9-759), with the JAX function's semantics:

- two-loop recursion over a bounded circular curvature history with the acceptance
  test ``y.s > 1e-10 ||s||^2`` and initial scaling ``H_diag = y.s / y.y``
  (reference :610-651);
- **batch mode** (stochastic): trust-region damping ``y += lm0 * s`` (reference
  :586-587) and an online inter-batch mean/variance estimate of the gradient that sets
  the maximum line-search step ``alphabar = 1 / (1 + sum(var) / ((n_iter - 1) ||g||))``
  (reference :592-607);
- **backtracking (Armijo) line search** with a negative-step retry for batch mode
  (reference :115-187);
- **cubic / strong-Wolfe line search** (Fletcher bracket + zoom, directional
  derivatives by central finite differences of the closure) for full-batch mode
  (reference :192-495);
- the same step-size seeding, NaN guards, termination tests and ``func_evals``
  accounting (reference :498-759).

Parameters are a dict of tensors keyed by name (a module's ``named_parameters``), and
so is every vector of the state.  JAX compiles the whole step, line searches
included, into one program of ``lax.while_loop``s and ``lax.cond``s; here the loops
are Python loops, and each branch reads its 0-dim predicate with ``.item()`` where it
is taken, as the reference's ``float(closure())`` did: one host synchronisation per
line-search probe and a few per iteration, counted in ``LBFGSState.host_syncs``.
Scalars that the JAX step keeps as float32 arrays (step sizes, ``alphabar``,
``H_diag``) stay float32 0-dim tensors on the parameters' device, so the arithmetic
rounds as it does there.  ``LBFGSConfig.unroll_outer`` chose between two lowerings
with bit-identical trajectories in JAX; the eager loop is the one lowering here, and
the field is accepted and has no effect.

Vector algebra: a dot product concatenates the tensors once and takes one ``dot``
(one sum over all parameters, where JAX sums per-leaf ``vdot``s in sorted-key order:
the two agree to float32 rounding); updates are ``torch._foreach_*`` calls.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple

import torch

from lshm_tpu_torch.config import LBFGSConfig

Vec = dict[str, torch.Tensor]

# ----------------------------------------------------------------------------------
# vector algebra on dicts of tensors (same keys, same order)
# ----------------------------------------------------------------------------------


def _flat(a: Vec) -> torch.Tensor:
    return torch.cat([v.reshape(-1) for v in a.values()])


def _tdot(a: Vec, b: Vec) -> torch.Tensor:
    return torch.dot(_flat(a), _flat(b))


def _tabs_sum(a: Vec) -> torch.Tensor:
    return _flat(a).abs().sum()


def _tsum(a: Vec) -> torch.Tensor:
    return _flat(a).sum()


def _taxpy(x: Vec, alpha, d: Vec) -> Vec:
    """x + alpha * d (alpha a 0-dim tensor or a number)."""
    return dict(zip(x, torch._foreach_add(list(x.values()),
                                          torch._foreach_mul(list(d.values()), alpha))))


def _tsub(a: Vec, b: Vec) -> Vec:
    return dict(zip(a, torch._foreach_sub(list(a.values()), list(b.values()))))


def _tscale(a: Vec, alpha) -> Vec:
    return dict(zip(a, torch._foreach_mul(list(a.values()), alpha)))


@dataclass
class LBFGSState:
    """Persistent optimizer state (survives across minibatch steps, like the reference's
    optimizer ``state`` dict; reference: src/lbfgsnew.py:743-756).  Vectors are dicts
    keyed by parameter name; the curvature history is a circular buffer [m, *shape]
    per parameter.  ``host_syncs`` is the port's own count of ``.item()`` reads."""

    s_hist: Vec                  # [m, *shape] recent steps s_i = t * d (circular)
    y_hist: Vec                  # [m, *shape] recent gradient differences
    hist_ptr: int                # next write slot
    hist_count: int              # number of valid pairs
    H_diag: torch.Tensor         # [] initial inverse-Hessian scale
    prev_grad: Vec
    prev_loss: torch.Tensor      # []
    d: Vec                       # last search direction
    t: torch.Tensor              # [] last step size
    n_iter: int                  # global iteration counter
    running_avg: Vec             # online mean of inter-batch gradients
    running_avg_sq: Vec          # online second central moment accumulator
    alphabar: torch.Tensor       # [] adaptive max step (batch mode)
    func_evals: int              # cumulative closure evaluations
    host_syncs: int = 0

    def state_dict(self) -> dict:
        """The fields as a dict, by reference (``torch.optim.Optimizer``'s interface:
        deep-copy it to keep a snapshot)."""
        return {k: getattr(self, k) for k in self.__dataclass_fields__}

    def load_state_dict(self, sd: dict) -> None:
        """Take every field from ``sd`` (by reference)."""
        for k in self.__dataclass_fields__:
            setattr(self, k, sd[k])


def lbfgs_init(params: Vec, cfg: LBFGSConfig) -> LBFGSState:
    """A fresh state shaped like ``params`` (a dict of float tensors)."""
    zeros = lambda: {k: torch.zeros_like(v) for k, v in params.items()}
    m = cfg.history_size
    hist = lambda: {k: v.new_zeros((m, *v.shape)) for k, v in params.items()}
    ref = next(iter(params.values()))
    scalar = lambda v: torch.tensor(v, dtype=ref.dtype, device=ref.device)
    return LBFGSState(
        s_hist=hist(), y_hist=hist(), hist_ptr=0, hist_count=0, H_diag=scalar(1.0),
        prev_grad=zeros(), prev_loss=scalar(0.0), d=zeros(), t=scalar(cfg.lr), n_iter=0,
        running_avg=zeros(), running_avg_sq=zeros(), alphabar=scalar(cfg.lr),
        func_evals=0,
    )


def _push_history(state: LBFGSState, s: Vec, y: Vec) -> None:
    """Write (s, y) at the circular pointer: one row per parameter."""
    ptr = state.hist_ptr
    m = next(iter(state.s_hist.values())).shape[0]
    for k in s:
        state.s_hist[k][ptr] = s[k]
        state.y_hist[k][ptr] = y[k]
    state.hist_ptr = (ptr + 1) % m
    state.hist_count = min(state.hist_count + 1, m)


def _two_loop(g: Vec, state: LBFGSState) -> Vec:
    """L-BFGS two-loop recursion over the valid part of the circular history
    (reference: src/lbfgsnew.py:637-651).  Newest pair at (ptr - 1) % m.  The JAX
    function runs all m slots with a zero coefficient for the invalid ones, which
    leaves q and r unchanged: here the invalid slots are skipped."""
    m = next(iter(state.s_hist.values())).shape[0]
    pair = lambda idx: ({k: h[idx] for k, h in state.s_hist.items()},
                        {k: h[idx] for k, h in state.y_hist.items()})
    q = _tscale(g, -1.0)
    al = []
    for i in range(state.hist_count):                       # newest -> oldest
        idx = (state.hist_ptr - 1 - i) % m
        s_i, y_i = pair(idx)
        a_i = (1.0 / _tdot(y_i, s_i)) * _tdot(s_i, q)
        q = _taxpy(q, -a_i, y_i)
        al.append((idx, a_i))
    r = _tscale(q, state.H_diag)
    for idx, a_i in reversed(al):                           # oldest -> newest
        s_i, y_i = pair(idx)
        be = (1.0 / _tdot(y_i, s_i)) * _tdot(y_i, r)
        r = _taxpy(r, a_i - be, s_i)
    return r


class _Reader:
    """Reads 0-dim predicates on the host, counting each read."""

    def __init__(self, state: LBFGSState):
        self.state = state

    def __call__(self, pred: torch.Tensor) -> bool:
        self.state.host_syncs += 1
        return bool(pred.item())


# ----------------------------------------------------------------------------------
# line searches (value-only closure)
# ----------------------------------------------------------------------------------

def _linesearch_backtrack(value_fn, x, d, g, alphabar, cfg: LBFGSConfig, f_old, read):
    """Armijo backtracking with negative-step retry (reference: src/lbfgsnew.py:115-187).
    ``f_old`` is the already-known loss at x.  Returns (alpha, n_evals): only halvings
    count, not the initial probes (reference :186)."""
    prodterm = cfg.ls_c1 * _tdot(g, d)

    def probe(alpha):
        return value_fn(_taxpy(x, alpha, d))

    def halve_while(alpha, ci):
        f_new = probe(alpha)
        while ci < cfg.ls_max_steps and read(
                torch.isnan(f_new) | (f_new > f_old + alpha * prodterm)):
            ci += 1
            alpha = 0.5 * alpha
            f_new = probe(alpha)
        return ci, alpha, f_new

    ci, alphak, f_new = halve_while(alphabar, 0)
    if read((f_old - f_new) < torch.abs(prodterm)):
        ci, alphak1, f_new1 = halve_while(-alphabar, ci)
        if read(f_new1 < f_new):
            alphak = alphak1
    return alphak, ci


def _cubic_min(phi, a, b, step, read):
    """Cubic interpolation on [a, b] with finite-difference derivatives
    (reference: src/lbfgsnew.py:319-405).  Returns (alpha, n_evals): 6 derivative
    probes + 1 for the in-range cubic-minimum probe; the degenerate denom == 0 return
    counts 0 (reference :368-369 precedes the counter update)."""
    f0 = phi(a)
    f0d = (phi(a + step) - phi(a - step)) / (2.0 * step)
    f1 = phi(b)
    f1d = (phi(b + step) - phi(b - step)) / (2.0 * step)
    aa = 3.0 * (f0 - f1) / (b - a) + f1d - f0d
    disc = aa * aa - f0d * f1d
    if not read(disc > 0.0):
        return torch.where(f0 < f1, a, b), 6
    cc = torch.sqrt(disc)
    denom = f1d - f0d + 2.0 * cc
    if read(denom == 0.0):
        return 0.5 * (a + b), 0
    z0 = b - (f1d + cc - aa) * (b - a) / denom
    in_range = read((z0 <= torch.maximum(a, b)) & (z0 >= torch.minimum(a, b)))
    # reference quirk kept: the probe point is a + z0*(b-a), not z0 itself
    fz0 = phi(a + z0 * (b - a)) if in_range else f0 + f1
    out = torch.where((f0 < f1) & (f0 < fz0), a, torch.where(f1 < fz0, b, z0))
    return out, 6 + int(in_range)


def _linesearch_zoom(phi, a, b, phi_0, gphi_0, step, cfg: LBFGSConfig, read):
    """Fletcher zoom (reference: src/lbfgsnew.py:412-495).  Returns (alpha, n_evals)."""
    aj, bj, alphaj, ev = a, b, a, 0
    for _ in range(4):
        p01 = aj + cfg.cubic_t2 * (bj - aj)
        p02 = bj - cfg.cubic_t3 * (bj - aj)
        alphaj, cev = _cubic_min(phi, p01, p02, step, read)
        phi_j = phi(alphaj)
        phi_aj = phi(aj)
        # reference accounting (src/lbfgsnew.py:453,468): interpolation probes + the
        # 2 phi probes every iteration + 2 derivative probes on the non-Armijo path
        ev += cev + 2
        if read((phi_j > phi_0 + cfg.cubic_rho * alphaj * gphi_0) | (phi_j >= phi_aj)):
            bj = alphaj
            continue
        gphi_j = (phi(alphaj + step) - phi(alphaj - step)) / (2.0 * step)
        ev += 2
        if read(((aj - alphaj) * gphi_j <= step)
                | (torch.abs(gphi_j) <= -cfg.cubic_sigma * gphi_0)):
            return alphaj, ev           # the JAX carry returns alphaj, not aj
        if read(gphi_j * (bj - aj) >= 0.0):
            bj = aj
        aj = alphaj
    return alphaj, ev


def _linesearch_cubic(phi, cfg: LBFGSConfig, lr, phi_0, read):
    """Strong-Wolfe cubic line search, full-batch mode (reference:
    src/lbfgsnew.py:192-316).  ``phi_0`` is the already-known loss at x.  Returns
    (alpha, n_evals)."""
    step = cfg.cubic_step
    scalar = lambda v: torch.tensor(v, dtype=phi_0.dtype, device=phi_0.device)
    tol = torch.clamp(phi_0 * 0.01, max=1e-6)
    gphi_0 = (phi(scalar(step)) - phi(scalar(-step))) / (2.0 * step)
    mu = (tol - phi_0) / (cfg.cubic_rho * gphi_0)
    # degenerate-derivative guards (reference :232-238): return 1.0; the early returns
    # precede the reference's counter update, so they count 0 evals
    if read((torch.abs(gphi_0) < 1e-12) | torch.isnan(mu)):
        return scalar(1.0), 0

    alphai, alphai1, phi_prev = scalar(10.0 * lr), scalar(0.0), phi_0
    ev = 3                              # reference :243: phi_0 + 2 gphi_0 probes
    for ci in range(1, 4):
        phi_i = phi(alphai)
        if read(phi_i < tol):           # condition 0: below tolerance
            return alphai, ev
        # condition 1: bracket [alphai1, alphai]
        c1 = phi_i > phi_0 + alphai * gphi_0
        if ci > 1:
            c1 = c1 | (phi_i >= phi_prev)
        if read(c1):
            ak, zev = _linesearch_zoom(phi, alphai1, alphai, phi_0, gphi_0, step, cfg,
                                       read)
            return ak, ev + zev
        gphi_i = (phi(alphai + step) - phi(alphai - step)) / (2.0 * step)
        # reference: breaking at c2/c3 does not count this iteration's probes (the
        # `closure_evals += 3` at :306 is never reached)
        if read(torch.abs(gphi_i) <= -cfg.cubic_sigma * gphi_0):
            return alphai, ev
        if read(gphi_i >= 0.0):
            ak, zev = _linesearch_zoom(phi, alphai, alphai1, phi_0, gphi_0, step, cfg,
                                       read)
            return ak, ev + zev
        # next interval (reference :294-301); the advancing path counts its 3 probes
        # (reference :306) + the interpolation's own evals
        ev += 3
        if read(mu <= 2.0 * alphai - alphai1):
            alphai, alphai1 = mu, alphai
        else:
            lo = 2.0 * alphai - alphai1
            hi = torch.minimum(mu, alphai + cfg.cubic_t1 * (alphai - alphai1))
            ai_next, iev = _cubic_min(phi, lo, hi, step, read)
            alphai = ai_next
            ev += iev
        phi_prev = phi_i
    return scalar(lr), ev


# ----------------------------------------------------------------------------------
# the optimizer step
# ----------------------------------------------------------------------------------

class LBFGSResult(NamedTuple):
    x: Vec
    state: LBFGSState
    loss: torch.Tensor


def value_and_grad(fn: Callable[..., torch.Tensor]) -> Callable[..., tuple]:
    """``fn(x, *args) -> loss`` to ``(x, *args) -> (loss, {name: dloss/dx[name]})``."""

    def vg(x: Vec, *args):
        with torch.enable_grad():
            xs = {k: v.detach().requires_grad_() for k, v in x.items()}
            loss = fn(xs, *args)
            grads = torch.autograd.grad(loss, list(xs.values()))
        return loss.detach(), dict(zip(xs, grads))

    return vg


def make_lbfgs_step(
    value_and_grad_fn_outer: Callable[..., tuple[torch.Tensor, Vec]],
    value_fn_outer: Callable[..., torch.Tensor],
    cfg: LBFGSConfig,
) -> Callable[..., LBFGSResult]:
    """One call = one ``optimizer.step(closure)`` of the reference: up to ``max_iter``
    L-BFGS iterations on the current closure.  Both closures take
    ``(params, *args)``; value-only probes run under ``torch.no_grad()`` unless
    ``cfg.cost_use_gradient`` (then they run the value-and-gradient closure, as the
    reference does, src/lbfgsnew.py:686-693).  ``state`` is updated in place."""
    lr = cfg.lr
    max_iter = cfg.max_iter
    max_eval = max_iter * 5 // 4
    lm0 = cfg.trust_region_lm0

    def step(x: Vec, state: LBFGSState, *args) -> LBFGSResult:
        read = _Reader(state)
        vg = lambda v: value_and_grad_fn_outer(v, *args)
        if cfg.cost_use_gradient:
            value_fn = lambda v: vg(v)[0]
        else:
            def value_fn(v):
                with torch.no_grad():
                    return value_fn_outer(v, *args)
        loss, g = vg(x)
        state.func_evals += 1
        abs_grad_sum0 = _tabs_sum(g)
        grad_nrm = torch.sqrt(_tdot(g, g))    # fixed at entry (reference :555)
        orig_loss = loss
        scalar = lambda v: torch.tensor(v, dtype=loss.dtype, device=loss.device)
        n_iter, current_evals = 0, 1
        done = read((abs_grad_sum0 <= cfg.tolerance_grad) | torch.isnan(grad_nrm))

        while not done and n_iter < max_iter:
            n_iter += 1
            gi = state.n_iter = state.n_iter + 1        # global iteration count
            first_global = gi == 1

            # ---- direction ----------------------------------------------------------
            y = _tsub(g, state.prev_grad)
            s = _tscale(state.d, state.t)
            if cfg.batch_mode:
                y = _taxpy(y, lm0, s)                   # trust region (reference :586)
            batch_changed = cfg.batch_mode and n_iter == 1 and gi > 1
            if batch_changed:
                # online inter-batch gradient statistics (reference :592-607)
                g_old = _tsub(g, state.running_avg)
                running_avg = _taxpy(state.running_avg, 1.0 / scalar(float(gi)), g_old)
                g_new = _tsub(g, running_avg)
                state.running_avg_sq = dict(zip(g, torch._foreach_add(
                    list(state.running_avg_sq.values()),
                    torch._foreach_mul(list(g_new.values()), list(g_old.values())))))
                state.running_avg = running_avg
                state.alphabar = 1.0 / (1.0 + _tsum(state.running_avg_sq)
                                        / (max(gi - 1, 1) * grad_nrm))
            if first_global:
                state.H_diag = scalar(1.0)
                state.hist_count = 0
            elif not batch_changed:
                ys = _tdot(y, s)
                if read(ys > 1e-10 * _tdot(s, s)):
                    _push_history(state, s, y)
                    state.H_diag = ys / _tdot(y, y)
            d = _tscale(g, -1.0) if first_global else _two_loop(g, state)
            state.prev_grad, state.prev_loss, state.d = g, loss, d

            # ---- step size ----------------------------------------------------------
            gtd = _tdot(g, d)
            if cfg.line_search:
                if cfg.batch_mode:
                    t, ls_evals = _linesearch_backtrack(
                        value_fn, x, d, g, state.alphabar, cfg, loss, read)
                else:
                    phi = lambda a: value_fn(_taxpy(x, a, d))
                    t, ls_evals = _linesearch_cubic(phi, cfg, lr, loss, read)
                t = torch.where(torch.isnan(t), scalar(lr), t)
                state.func_evals += ls_evals
            elif first_global:
                t = torch.clamp(1.0 / abs_grad_sum0, max=1.0) * lr
            else:
                t = scalar(lr)

            x = _taxpy(x, t, d)
            state.t = t

            # ---- re-evaluate (except on the announced last iteration) -------------
            if n_iter != max_iter:
                loss_new, g_next = vg(x)
                current_evals += 1
                state.func_evals += 1
            else:
                loss_new, g_next = loss, g
            abs_grad_sum = _tabs_sum(g_next)

            # ---- termination tests (reference :725-741) ----------------------------
            done = (n_iter == max_iter or current_evals >= max_eval or read(
                torch.isnan(abs_grad_sum)
                | (abs_grad_sum <= cfg.tolerance_grad)
                | (gtd > -cfg.tolerance_change)
                | (torch.abs(t) * _tabs_sum(d) <= cfg.tolerance_change)
                | (torch.abs(loss_new - state.prev_loss) < cfg.tolerance_change)))
            loss, g = loss_new, g_next
        return LBFGSResult(x=x, state=state, loss=orig_loss)

    return step


class LBFGS:
    """Convenience wrapper: holds params + state and runs the step."""

    def __init__(self, loss_fn: Callable[[Vec], torch.Tensor], params: Vec,
                 cfg: LBFGSConfig):
        self.cfg = cfg
        self._step = make_lbfgs_step(value_and_grad(loss_fn), loss_fn, cfg)
        self.state = lbfgs_init(params, cfg)
        self._params = {k: v.detach() for k, v in params.items()}

    @property
    def params(self) -> Vec:
        return self._params

    def step(self) -> float:
        res = self._step(self._params, self.state)
        self._params, self.state = res.x, res.state
        return float(res.loss)

"""The arithmetic of the cluster kernels K1/K2 (``lshm_tpu_torch/csrc/khm.cu``),
emulated on the CPU in the order in which the kernels sum, against the port's plain
versions (1e-5 values, 2e-5 gradients), the JAX Pallas kernel in interpret mode (the
JAX suite's 1e-5 / 2e-4) and a float64 evaluation (no farther than twice the plain
version's distance).

The emulation repeats the kernels' decomposition: G CTAs (the wrapper's ``CLUSTER``),
rank r taking the rows r, r + G, r + 2 G, ... in order; each lane sums x_d m_kd over
d = lane + 32 j with fused multiply-adds, and a tree over the 32 lane sums with the
pairing of an xor butterfly (what the kernels' reduce-scatter computes, bit for bit);
e, sum_k c_ik and sum_k c_ik m_k chunk by chunk (8 centroids at a time, then 4, 2, 1:
each chunk's sum in order, then the chunks' sums in order); the loss over each CTA's
rows in row order, then over the ranks; dM over each CTA's rows in row order, then over
the ranks.  The warps per CTA and the rows per round do not enter these orders.
Products-then-sums that the compiler contracts are emulated as one rounding of the
float64 result (exact products), so the emulation follows the kernel to within a rare
double rounding, far inside the tolerances.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lshm_tpu.kernels import khm_loss_fused as jax_khm_fused
from lshm_tpu_torch.kernels import khm as tk

F32 = np.float32
EPS = F32(1e-9)


def _fma(a, b, c):
    """a b + c with one rounding to float32 (the product is exact in float64)."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64) + c).astype(F32)


def _lanes(a: np.ndarray) -> np.ndarray:
    """[..., D] -> [..., J, 32]: element d = lane + 32 j, zero-padded (an fma with 0 x 0
    leaves a sum as it is)."""
    D = a.shape[-1]
    pad = (-D) % 32
    a = np.concatenate([a, np.zeros(a.shape[:-1] + (pad,), F32)], axis=-1)
    return a.reshape(a.shape[:-1] + (-1, 32))


def _butterfly(v: np.ndarray) -> np.ndarray:
    """The value every lane holds after the xor butterfly over the last axis (32)."""
    for off in (16, 8, 4, 2, 1):
        v = v[..., :off] + v[..., off:2 * off]
    return v[..., 0]


def _ipow(x: np.ndarray, n: int) -> np.ndarray:
    acc = np.ones_like(x)
    for _ in range(n):
        acc = acc * x
    return acc


def _sq_dists(X, M):
    """d2 [N, K] as sq_dists computes it (|m|^2 as load_centroids does)."""
    xl, ml = _lanes(X), _lanes(M)                    # [N, J, 32], [K, J, 32]
    mm = np.zeros((M.shape[0], 32), F32)
    xx = np.zeros((X.shape[0], 32), F32)
    dot = np.zeros((X.shape[0], M.shape[0], 32), F32)
    for j in range(xl.shape[1]):
        mm = _fma(ml[:, j], ml[:, j], mm)
        xx = _fma(xl[:, j], xl[:, j], xx)
        dot = _fma(xl[:, None, j], ml[None, :, j], dot)
    mm, xx, dot = _butterfly(mm), _butterfly(xx), _butterfly(dot)
    return np.maximum(_fma(F32(-2.0), dot, (xx[:, None] + mm[None, :])), F32(0.0))


def _cta_rows(N: int, G: int) -> np.ndarray:
    """[steps, G] row indices (-1: none): rank r's rows r, r + G, r + 2 G, ... in order
    (whatever the round size: slot s of a round is row base + G s)."""
    steps = -(-N // G)
    rows = np.arange(steps * G).reshape(steps, G)
    return np.where(rows < N, rows, -1)


def _chunks(K: int) -> list[range]:
    """The kernels' chunks of centroids: 8 at a time, then at most one of 4, 2, 1."""
    out, k0 = [range(k, k + 8) for k in range(0, K - K % 8, 8)], K - K % 8
    for w in (4, 2, 1):
        if K - k0 >= w:
            out.append(range(k0, k0 + w))
            k0 += w
    return out


def _sum_k(K: int, step) -> np.ndarray:
    """sum over k < K with step(k, acc) -> acc + term k: each chunk's sum in order, then
    the chunks' sums in order."""
    total = None
    for ks in _chunks(K):
        part = F32(0.0)
        for k in ks:
            part = step(k, part)
        total = part if total is None else total + part
    return total


def emulate_forward(X, M, p, G):
    N, D = X.shape
    K = M.shape[0]
    d2 = _sq_dists(X, M)
    r = F32(1.0) / (_ipow(d2, p // 2) + EPS)
    e = _sum_k(K, lambda k, acc: acc + r[:, k])
    contrib = F32(K) / (e + EPS)
    cta = np.zeros(G, F32)
    for rows in _cta_rows(N, G):                     # each CTA's rows in order
        cta = np.where(rows >= 0, cta + contrib[np.maximum(rows, 0)], cta)
    total = F32(0.0)
    for r in range(G):
        total = F32(total + cta[r])
    return F32(total / (F32(N) * F32(K) * F32(D))), e[:, None]


def emulate_backward(X, M, e, g, p, G, drop_rank=None):
    N, D = X.shape
    K = M.shape[0]
    d2 = _sq_dists(X, M)
    ee = e[:, 0] + EPS
    denom_e = (F32(N) * F32(D)) * (ee * ee)
    t = _ipow(d2, p // 2) + EPS
    c = ((F32(p) * _ipow(d2, p // 2 - 1)) / (denom_e[:, None] * t * t)) * F32(g)
    crow = _sum_k(K, lambda k, acc: acc + c[:, k])
    cm = _sum_k(K, lambda k, acc: _fma(c[:, k:k + 1], M[k][None, :], acc))
    dX = _fma(crow[:, None], X, -cm)
    cx = np.zeros((G, K, D), F32)
    csum = np.zeros((G, K), F32)
    for i in _cta_rows(N, G):                        # each CTA's rows in row order
        live = (i >= 0)[:, None]
        ci = c[np.maximum(i, 0)]                     # [G, K]
        xi = X[np.maximum(i, 0)]                     # [G, D]
        cx = np.where(live[:, :, None], _fma(ci[:, :, None], xi[:, None, :], cx), cx)
        csum = np.where(live, csum + ci, csum)
    part = _fma(csum[:, :, None], M[None], -cx)
    dM = np.zeros((K, D), F32)
    for r in range(G):
        if r != drop_rank:
            dM = dM + part[r]
    return dX, dM


def _f64(X, M, p):
    """loss, e, dX, dM (cotangent 1) in float64, d2 from the differences."""
    X, M = X.astype(np.float64), M.astype(np.float64)
    N, D = X.shape
    K = M.shape[0]
    d2 = ((X[:, None, :] - M[None]) ** 2).sum(-1)
    t = d2 ** (p // 2) + 1e-9
    e = (1.0 / t).sum(-1, keepdims=True)
    loss = (K / (e + 1e-9)).sum() / (N * K * D)
    c = p * d2 ** (p // 2 - 1) / ((N * D) * (e + 1e-9) ** 2 * t * t)
    return loss, e, c.sum(-1, keepdims=True) * X - c @ M, c.sum(0)[:, None] * M - c.T @ X


def _data(n, k, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, d)).astype(F32), rng.uniform(size=(k, d)).astype(F32))


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-30))


# (N, K, D): the main path (full_khm and Fourier latents), a larger batch, a small
# case, a ragged D, a K above the 8-centroid chunk, and a K whose M does not fit in
# shared memory beside K2's sums
CASES = [(420, 10, 256), (420, 10, 288), (2500, 10, 256), (5, 3, 128), (48, 6, 72),
         (200, 21, 96), (420, 200, 256)]


@pytest.mark.parametrize("n,k,d", CASES)
def test_cluster_arithmetic_matches_plain_jax_and_f64(n, k, d):
    X, M = _data(n, k, d, seed=n + k + d)
    p, G = 4, tk.CLUSTER
    loss, e = emulate_forward(X, M, p, G)
    dX, dM = emulate_backward(X, M, e, 1.0, p, G)

    Xt, Mt = torch.from_numpy(X), torch.from_numpy(M)
    loss_p, e_p = tk.khm_forward_plain(Xt, Mt, p)
    dX_p, dM_p = tk.khm_backward_plain(Xt, Mt, e_p, torch.tensor(1.0), p)
    assert max(_rel(loss, loss_p), _rel(e, e_p)) <= 1e-5
    assert max(_rel(dX, dX_p), _rel(dM, dM_p)) <= 2e-5

    f = lambda x, m: jax_khm_fused(x, m, p, force="interpret")
    want = float(f(jnp.asarray(X), jnp.asarray(M)))
    gx_w, gm_w = jax.grad(f, argnums=(0, 1))(jnp.asarray(X), jnp.asarray(M))
    np.testing.assert_allclose(loss, want, rtol=1e-5)
    np.testing.assert_allclose(dX, np.asarray(gx_w), rtol=2e-4, atol=1e-8)
    np.testing.assert_allclose(dM, np.asarray(gm_w), rtol=2e-4, atol=1e-8)

    loss64, e64, dX64, dM64 = _f64(X, M, p)
    fwd = {name: max(_rel(a, loss64), _rel(b, e64))
           for name, (a, b) in {"kernel": (loss, e), "plain": (loss_p, e_p)}.items()}
    bwd = {name: max(_rel(a, dX64), _rel(b, dM64))
           for name, (a, b) in {"kernel": (dX, dM), "plain": (dX_p, dM_p)}.items()}
    assert fwd["kernel"] <= 2 * fwd["plain"], fwd
    assert bwd["kernel"] <= 2 * bwd["plain"], bwd


def test_emulation_sees_a_lost_rank():
    """Negative case: a dM without the last CTA's partial fails the 2e-5 gate."""
    X, M = _data(420, 10, 256, seed=1)
    _, e = emulate_forward(X, M, 4, tk.CLUSTER)
    _, dM = emulate_backward(X, M, e, 1.0, 4, tk.CLUSTER)
    _, dM_less = emulate_backward(X, M, e, 1.0, 4, tk.CLUSTER, drop_rank=tk.CLUSTER - 1)
    assert _rel(dM_less, dM) > 2e-5


def test_one_sum_over_all_k_fails_the_float64_rule():
    """Negative case: at K = 200, e_i summed over k in one run (the two-pass kernels'
    order) lies more than twice as far from float64 as the plain version; the kernels'
    chunk-by-chunk sum does not."""
    X, M = _data(420, 200, 256, seed=876)
    r = F32(1.0) / (_ipow(_sq_dists(X, M), 2) + EPS)
    one_run = np.zeros(420, F32)
    for k in range(200):
        one_run = one_run + r[:, k]
    _, e64, _, _ = _f64(X, M, 4)
    _, e_p = tk.khm_forward_plain(torch.from_numpy(X), torch.from_numpy(M), 4)
    _, e = emulate_forward(X, M, 4, tk.CLUSTER)
    assert _rel(one_run[:, None], e64) > 2 * _rel(e_p, e64)
    assert _rel(e, e64) <= 2 * _rel(e_p, e64)


def _old_fits(k: int, d: int) -> bool:
    """The shared memory of the two-pass kernels (8 warps a block)."""
    return 4 * (k * d + k + 8 * d + 8 * k) <= 232448


@pytest.mark.parametrize("k", [1, 3, 10, 16, 17, 64, 200, 1000, 5000])
def test_plan_takes_every_shape_the_former_kernels_took(k):
    for d in list(range(1, 300, 7)) + list(range(300, 8000, 97)):
        if _old_fits(k, d):
            w_fwd, w_bwd, _ = tk.plan(k, d)
            assert 1 <= w_fwd <= 32 and 1 <= w_bwd <= 32
    with pytest.raises(ValueError, match="shared memory"):
        tk.plan(k, 232448 // 4 // k + 1)


def test_wrappers_raise_and_cpu_calls_count_no_launch():
    X, M = (torch.from_numpy(a) for a in _data(16, 3, 32, seed=2))
    with pytest.raises(TypeError):
        tk.khm_forward(X.bfloat16(), M, 4)
    with pytest.raises(ValueError, match="contiguous"):
        tk.khm_forward(X.t().contiguous().t(), M, 4)
    with pytest.raises(ValueError, match="even p"):
        tk.khm_forward(X, M, 3)
    loss, e = tk.khm_forward(X, M, 4)
    with pytest.raises(ValueError, match="even p"):
        tk.khm_backward(X, M, e, torch.tensor(1.0), 5)
    before = dict(tk.launches)
    tk.khm_backward(X, M, e, torch.tensor(1.0), 4)
    tk.khm_forward(X, M, 4)
    assert tk.launches == before


def test_profile_step_counts_each_reduction_under_its_kernel():
    """tools/profile_step.py's port_kernels row: a fixed-order reduction counts under
    the port kernel launched just before it, whatever the order of the events."""
    from types import SimpleNamespace

    from lshm_tpu_torch.tools.profile_step import _port_kernels

    def ev(name, start, us):
        return SimpleNamespace(name=name, time_range=SimpleNamespace(
            start=start, elapsed_us=lambda: us))

    kern = [ev("lshm::reduce_partials_kernel(float const*, int, int, float, float*)", 3, 2.0),
            ev("void tc::head_bwd_f32_tc_kernel<4>(float const*)", 2, 500.0),
            ev("(anonymous namespace)::khm_fwd_cluster_kernel(float const*)", 0, 7.0),
            ev("(anonymous namespace)::khm_fwd_cluster_kernel(float const*)", 10, 7.5),
            ev("void at::native::elementwise_kernel<128, 2>(int)", 1, 1.0)]
    rows = {r["name"]: r for r in _port_kernels(kern)}
    assert set(rows) == {"tc::head_bwd_f32_tc_kernel<4>", "khm_fwd_cluster_kernel",
                         "lshm::reduce_partials_kernel after tc::head_bwd_f32_tc_kernel<4>"}
    assert rows["khm_fwd_cluster_kernel"]["calls"] == 2
    assert rows["khm_fwd_cluster_kernel"]["us_per_call"] == 7.25

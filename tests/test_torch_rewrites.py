"""The exact rewrites of the port (``model.fuse_1d``, ``model.fast_conv1d``,
``model.packed_conv2d``) and ``losses.recon_admm_losses`` against the JAX package's:
each op's forward and vjp at the small shapes of tests/test_models.py:197-252 (1e-5),
``recon_admm_losses`` at tests/test_losses.py:168-210's tolerances, and ``CascadedAE``
with each flag against JAX's with the same flag, parameters bridged by ``params.py``, at
2 patches (outputs 1e-5, parameter gradients 2e-5 relative, as in
tests/test_torch_models.py; ``bfloat16_full``: outputs 2e-2 relative, as in
tests/test_torch_bf16.py, and the loss terms within JAX's bf16 gate 0.05 |a| + 5e-3,
tests/test_bf16.py:61)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lshm_tpu import losses as jl
from lshm_tpu.config import ModelConfig as JModelConfig
from lshm_tpu.models import CascadedAE as JCascadedAE
from lshm_tpu.models import autoencoders as ja
from lshm_tpu.train import LossWeights as JLossWeights
from lshm_tpu.train.objective import Duals as JDuals
from lshm_tpu.train.objective import loss_from_outputs as j_loss_from_outputs
from lshm_tpu_torch import losses as tl
from lshm_tpu_torch.config import ModelConfig
from lshm_tpu_torch.models import CascadedAE
from lshm_tpu_torch.models import autoencoders as ta
from lshm_tpu_torch.params import _conv_to_torch, _tconv_to_torch, to_flax
from lshm_tpu_torch.train import Duals, LossWeights, loss_from_outputs



@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs six workers on the host's cores, and torch's default of a thread
    per core in each makes these small CPU steps 10-20 times slower than alone, so
    this file runs torch on one thread (both sides of every comparison alike)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

def _rel(a, b):
    return float(np.max(np.abs(a - b))) / (float(np.max(np.abs(b))) + 1e-30)


def _t(a):
    return torch.tensor(np.ascontiguousarray(a), requires_grad=True)


# ---------------------------------------------------------------------------- ops
# (name, JAX function, port function, x shape (JAX layout), JAX kernel shape, ndim,
#  transposed); the port takes x channels-first and the weight in torch's layout

OPS = {
    "conv1d_s4": (ja.conv1d_s4, ta.conv1d_s4, (3, 64, 5), (4, 5, 7), 1, False),
    "convt1d_s4": (ja.convt1d_s4, lambda h, w: ta._convt1d_taps(h, w, w.new_zeros(w.shape[1])),
                   (3, 16, 6), (4, 6, 5), 1, True),
    "conv2d_s2_packed": (ja.conv2d_s2_packed, ta.conv2d_s2_packed, (3, 16, 16, 4),
                         (4, 4, 4, 8), 2, False),
    "convt2d_s2_packed": (ja.convt2d_s2_packed, ta.convt2d_s2_packed, (3, 8, 8, 6),
                          (4, 4, 6, 4), 2, True),
}


@pytest.mark.parametrize("name", sorted(OPS))
def test_op_matches_jax(name):
    """Forward and the vjp with respect to input and kernel (JAX's kernels: WIO/HWIO,
    flax ConvTranspose unflipped; the port's OIW/OIHW and IOW/IOHW)."""
    jfn, tfn, xs, ks, ndim, transposed = OPS[name]
    rng = np.random.default_rng(len(name))
    x = rng.normal(size=xs).astype(np.float32)
    k = rng.normal(size=ks).astype(np.float32)
    to_cf = (0, 2, 1) if ndim == 1 else (0, 3, 1, 2)
    to_cl = (0, 2, 1) if ndim == 1 else (0, 2, 3, 1)
    y_j, vjp = jax.vjp(jfn, jnp.asarray(x), jnp.asarray(k))
    ct = rng.normal(size=y_j.shape).astype(np.float32)
    dx_j, dk_j = vjp(jnp.asarray(ct))

    w = (_tconv_to_torch if transposed else _conv_to_torch)(k, ndim)
    xt, wt = _t(x.transpose(to_cf)), _t(w)
    y = tfn(xt, wt)
    assert _rel(y.detach().numpy().transpose(to_cl), np.asarray(y_j)) < 1e-5
    y.backward(torch.from_numpy(ct.transpose(to_cf).copy()))
    assert _rel(xt.grad.numpy().transpose(to_cl), np.asarray(dx_j)) < 1e-5
    dk = (_tconv_to_torch if transposed else _conv_to_torch)(np.asarray(dk_j), ndim)
    assert _rel(wt.grad.numpy(), dk) < 1e-5


def test_conv1d_s4_refuses_a_length_not_divisible_by_4():
    with pytest.raises(ValueError, match="divisible by 4"):
        ta.conv1d_s4(torch.zeros(1, 2, 10), torch.zeros(3, 2, 4))
    with pytest.raises(ValueError, match="divisible by 4"):
        ja.conv1d_s4(jnp.zeros((1, 10, 2)), jnp.zeros((4, 2, 3)))


def test_bf16_conv1d_gradients_are_right_on_the_cpu():
    """PyTorch's CPU bf16 conv_transpose1d returns a wrong input gradient at one 1D AE
    shape (tests/test_torch_bf16_train.py); the stride-4 convs' gradients in bf16 do
    not: ``conv1d_s4`` and the grouped conv of ``fused_dual_ae1d`` at the six 1D AE
    layer shapes lie within bf16 rounding (1e-2 of the largest value) of float32's on
    the same bf16-rounded inputs."""
    rng = np.random.default_rng(3)
    shapes = [(4, 8, 16384), (8, 12, 4096), (12, 24, 1024), (24, 48, 256), (48, 96, 64),
              (96, 192, 16)]
    forms = {"conv1d_s4": lambda x, w: ta.conv1d_s4(x, w),
             "grouped": lambda x, w: torch.nn.functional.conv1d(
                 torch.cat([x, x.flip(1)], 1), torch.cat([w, w]), stride=4, padding=1,
                 groups=2)}
    for c, f, L in shapes:
        x = torch.from_numpy(rng.normal(size=(1, c, L)).astype(np.float32)).bfloat16()
        w = torch.from_numpy(rng.normal(size=(f, c, 4)).astype(np.float32) / c).bfloat16()
        for name, form in forms.items():
            grads = []
            for dtype in (torch.bfloat16, torch.float32):
                xx, ww = x.to(dtype).requires_grad_(), w.to(dtype).requires_grad_()
                y = form(xx, ww)
                g = torch.from_numpy(np.cos(np.arange(y.numel(), dtype=np.float32))
                                     .reshape(y.shape)).bfloat16().to(dtype)
                grads.append(torch.autograd.grad(y, (xx, ww), g))
            for got, want in zip(*grads):
                assert _rel(got.float().numpy(), want.numpy()) < 1e-2, (name, c, f, L)


@pytest.mark.parametrize("flat", [False, True], ids=["shaped", "flat"])
def test_recon_admm_losses_matches_jax_and_autograd(flat):
    """The four terms and the gradients of a weighted sum of them with respect to x1,
    x2 and x3: against JAX's custom VJP and against autograd through the port's
    term-by-term form (values 1e-6, gradients rtol 1e-5, atol 1e-7)."""
    rng = np.random.default_rng(11)
    shape = (3, 8, 8, 2)
    numel = int(np.prod(shape))
    x, x1, x2, x3 = (rng.normal(size=shape).astype(np.float32) for _ in range(4))
    ys = [rng.normal(size=(numel,) if flat else shape).astype(np.float32) for _ in range(3)]
    rho, wts = 0.7, (1.0, 2.0, 3.0, 4.0)

    def tot_j(a1, a2, a3):
        t = jl.recon_admm_losses(a1, a2, a3, jnp.asarray(x), *map(jnp.asarray, ys), rho)
        return sum(c * v for c, v in zip(wts, t)), t

    (_, want), grads_j = jax.value_and_grad(tot_j, argnums=(0, 1, 2), has_aux=True)(
        *map(jnp.asarray, (x1, x2, x3)))

    xt = torch.from_numpy(x)
    yt = [torch.from_numpy(y) for y in ys]

    def naive(a1, a2, a3):
        x11 = (xt - a1) * 0.5
        return (tl.mse_sum(a1 + a2 + a3, xt) / numel,
                tl.admm_term(yt[0], xt - a1, rho) / numel,
                tl.admm_term(yt[1], x11 - a2, rho) / numel,
                tl.admm_term(yt[2], x11 - a3, rho) / numel)

    for form in (lambda *a: tl.recon_admm_losses(*a, xt, *yt, rho), naive):
        args = [_t(a) for a in (x1, x2, x3)]
        terms = form(*args)
        np.testing.assert_allclose([float(v.detach()) for v in terms], np.asarray(want),
                                   rtol=1e-6, atol=1e-6)
        sum(c * v for c, v in zip(wts, terms)).backward()
        for a, g in zip(args, grads_j):
            np.testing.assert_allclose(a.grad.numpy(), np.asarray(g), rtol=1e-5, atol=1e-7)
    assert all(not t.requires_grad for t in (xt, *yt))


# ------------------------------------------------------------------------- modules

N = 2
MODEL = dict(latent_dim=16, latent_dim_1d=8, num_clusters=3)
ALL = dict(fuse_1d=True, fast_conv1d=True, packed_conv2d=2)
# id: (flags of both packages, the port's pallas_head, compute dtype)
# JAX compiles each op shape once per process, so the cases run in one file, in the
# order that reuses shapes (depth 6 compiles the packed shapes of depths 1 and 2)
CASES = {
    "fuse_1d": (dict(fuse_1d=True), False, "float32"),
    "fuse_1d-norica": (dict(fuse_1d=True, rica=False), False, "float32"),
    "packed6": (dict(packed_conv2d=6), False, "float32"),
    "all-head": (dict(ALL, packed_conv2d=6), True, "float32"),
    "packed1": (dict(packed_conv2d=1), False, "float32"),
    "packed2": (dict(packed_conv2d=2), False, "float32"),
    "fast_conv1d": (dict(fast_conv1d=True), False, "float32"),
    "all-bf16_full": (ALL, True, "bfloat16_full"),
}
OUTPUTS = ("x1", "x11", "x2", "x3", "xrecon", "Mu", "mu", "muT", "muF")


@pytest.mark.parametrize("case", list(CASES))
def test_cascade_with_rewrites_matches_jax(case):
    """The port's cascade with the flags of ``CASES[case]`` against JAX's with the same
    flags (JAX without its Pallas head: the port's head is the same math, held to JAX
    elsewhere).  float32: every output 1e-5, every parameter gradient 2e-5.
    bfloat16_full (both sides cast the input to bf16, as the step does): the outputs
    2e-2 relative and the loss terms of those outputs within JAX's gate."""
    flags, head, dtype = CASES[case]
    rng = np.random.default_rng(2)
    x = rng.normal(size=(N, 128, 128, 4)).astype(np.float32)
    uv = (rng.normal(size=(N, 2)) * 300).astype(np.float32)
    cfg = dict(MODEL, **flags, compute_dtype=dtype)
    port = CascadedAE(ModelConfig(**cfg, pallas_head=head),
                      generator=torch.Generator().manual_seed(4))
    jmod = JCascadedAE(cfg=JModelConfig(**cfg))
    params = to_flax(port.state_dict())
    bf16 = dtype == "bfloat16_full"
    xj = jnp.asarray(x).astype(jnp.bfloat16) if bf16 else jnp.asarray(x)
    xt = torch.from_numpy(x).to(torch.bfloat16) if bf16 else torch.from_numpy(x)
    out_j = jmod.apply(params, xj, jnp.asarray(uv))
    out = port(xt, torch.from_numpy(uv))
    for name in OUTPUTS:
        got = getattr(out, name).detach().float().numpy()
        want = np.asarray(getattr(out_j, name).astype(jnp.float32))
        assert _rel(got, want) < (2e-2 if bf16 else 1e-5), name
    if bf16:
        # the loss terms of these outputs (zero duals) at JAX's bf16 gate
        _, want = j_loss_from_outputs(out_j, params["params"]["khm"]["M"], xj,
                                      JDuals.zeros_like(xj), JLossWeights(), 1)
        _, got = loss_from_outputs(out, port.khm.M, xt, Duals.zeros_like(xt),
                                   LossWeights(), 1)
        for k, v in want.items():
            a, b = float(v), float(got[k].detach())
            assert abs(a - b) <= 0.05 * abs(a) + 5e-3, (k, a, b)
        return

    cts = {k: np.random.default_rng(i).normal(size=getattr(out_j, k).shape)
           .astype(np.float32) for i, k in enumerate(("xrecon", "x11", "Mu"))}

    def loss_j(p):
        o = jmod.apply(p, jnp.asarray(x), jnp.asarray(uv))
        return sum(jnp.sum(getattr(o, k) * c) for k, c in cts.items())

    want = jax.grad(loss_j)(params)
    sum(torch.sum(getattr(out, k) * torch.from_numpy(c)) for k, c in cts.items()).backward()
    got = to_flax({n: p.grad if p.grad is not None else torch.zeros_like(p)
                   for n, p in port.named_parameters()})
    got_l = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    for path, w in jax.tree_util.tree_flatten_with_path(want)[0]:
        assert _rel(np.asarray(got_l[path]), np.asarray(w)) < 2e-5, jax.tree_util.keystr(path)


def test_fused_dual_ae1d_is_the_two_aes():
    """``fused_dual_ae1d`` on two modules' parameters equals running them one by one,
    in float32 and in bf16 (its grouped transposed convs are matrix products there),
    and it works under ``functional_call`` (the L-BFGS closure)."""
    from torch.func import functional_call

    rng = np.random.default_rng(5)
    sT, sF = (torch.from_numpy(rng.normal(size=(1, 128 * 128, 4)).astype(np.float32))
              for _ in range(2))
    uv = torch.from_numpy((rng.normal(size=(1, 2)) * 300).astype(np.float32))
    for dtype, tol in ((torch.float32, 1e-6), (torch.bfloat16, 2e-2)):
        g = torch.Generator().manual_seed(1)
        aeT, aeF = (ta.AutoEncoder1D(latent_dim=8, dtype=dtype, generator=g) for _ in range(2))
        uvf = ta.uv_harmonic_features(uv, aeT.harmonic_scales)
        fused = ta.fused_dual_ae1d(aeT, aeF, sT, sF, uvf, True, dtype)
        for (y, mu), ae, s in zip(fused, (aeT, aeF), (sT, sF)):
            y0, mu0 = ae(s, uv)
            assert y.shape == y0.shape and y.dtype == dtype
            assert _rel(y.detach().float().numpy(), y0.detach().float().numpy()) < tol
            assert _rel(mu.detach().float().numpy(), mu0.detach().float().numpy()) < tol
    # functional_call substitutes the parameters the fused stack reads
    cfg = ModelConfig(**MODEL, fuse_1d=True, pallas_head=False)
    model = CascadedAE(cfg, generator=torch.Generator().manual_seed(3))
    x = torch.from_numpy(rng.normal(size=(1, 128, 128, 4)).astype(np.float32))
    sd = {k: v * 0.5 for k, v in model.state_dict().items()}
    want = CascadedAE(cfg)
    want.load_state_dict(sd)
    got = functional_call(model, sd, (x, uv))
    assert torch.equal(got.xrecon, want(x, uv).xrecon)

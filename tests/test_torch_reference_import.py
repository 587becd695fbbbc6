"""The port's importer of the reference's ``.model`` files against the JAX package's
(``lshm_tpu.utils.torch_import``): files written with ``torch.save`` from a seed, in
the reference's state-dict layout, for the cascade (net, netT, netF, khm) and the
legacy Fourier form (net, fnet, khm).  Both packages load them and their forwards
agree within 1e-5 (relative to the largest value); ``Trainer.load`` takes them as a
params-only checkpoint."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lshm_tpu.config import ModelConfig as JModelConfig
from lshm_tpu.models import CascadedAE as JCascadedAE
from lshm_tpu.utils import torch_import as jimport
from lshm_tpu_torch import config as tc
from lshm_tpu_torch.models import CascadedAE
from lshm_tpu_torch.train import Trainer
from lshm_tpu_torch.utils import MetricLogger, save_checkpoint
from lshm_tpu_torch.utils import torch_import

SCALES = (1e-4, 1e-3, 1e-2, 1e-1)
LADDER = (8, 12, 24, 48, 96, 192)
MODEL = dict(latent_dim=16, latent_dim_1d=8, latent_dim_fourier=8, num_clusters=4)


def reference_sd(rng, ndim, channels, latent, rica=True):
    """Random weights in the state-dict layout of the reference's AE modules
    (reference: src/lofar_models.py:12-184): OIHW / OIW convolutions, IOHW / IOW
    transposed convolutions, [out, in] linear layers."""
    sd = {}
    cin = channels
    for i, cout in enumerate(LADDER):
        sd[f"conv{i}.weight"] = rng.normal(size=(cout, cin) + (4,) * ndim, scale=0.2)
        sd[f"conv{i}.bias"] = rng.normal(size=cout, scale=0.1)
        cin = cout
    for i, cout in enumerate(list(LADDER[-2::-1]) + [channels]):
        sd[f"tconv{i}.weight"] = rng.normal(size=(cin, cout) + (4,) * ndim, scale=0.2)
        sd[f"tconv{i}.bias"] = rng.normal(size=cout, scale=0.1)
        cin = cout
    H = len(SCALES) * 4
    dense = {"fcuv1": (H, H), "fcuv3": (H, H), "fc1": (latent, 768 + H),
             "fc3": (768, latent + H)}
    if rica:
        dense.update(fc2in=(latent, latent), fc2out=(latent, latent))
    for name, (o, i) in dense.items():
        sd[f"{name}.weight"] = rng.normal(size=(o, i), scale=0.05)
        sd[f"{name}.bias"] = rng.normal(size=o, scale=0.05)
    return {k: torch.from_numpy(v.astype(np.float32)) for k, v in sd.items()}


def write_models(tmp_path, fourier: bool, seed: int = 0) -> dict[str, str]:
    """The reference's ``{'model_state_dict': ...}`` files; with RICA layers, as the
    reference trains them."""
    rng = np.random.default_rng(seed)
    L, Lt = MODEL["latent_dim"], MODEL["latent_dim_1d"]
    if fourier:
        nets = {"net": (2, 4, L), "fnet": (2, 8, MODEL["latent_dim_fourier"])}
        D = L + MODEL["latent_dim_fourier"]
    else:
        nets = {"net": (2, 4, L), "netT": (1, 4, Lt), "netF": (1, 4, Lt)}
        D = L + 2 * Lt
    sds = {name: reference_sd(rng, *shape) for name, shape in nets.items()}
    sds["khm"] = {"M": torch.from_numpy(rng.uniform(size=(4, D)).astype(np.float32))}
    paths = {}
    for name, sd in sds.items():
        paths[name] = str(tmp_path / f"{name}.model")
        torch.save({"model_state_dict": sd}, paths[name])
    return paths


def _import(paths, fourier, rica, pkg):
    if fourier:
        return pkg.load_reference_checkpoints_fourier(paths["net"], paths["fnet"],
                                                      paths["khm"], rica=rica)
    return pkg.load_reference_checkpoints(paths["net"], paths["netT"], paths["netF"],
                                          paths["khm"], rica=rica)


def _rel(a, b):
    return float(np.max(np.abs(a - b))) / (float(np.max(np.abs(b))) + 1e-30)


@pytest.mark.parametrize("fourier", [False, True], ids=["cascade", "fourier"])
def test_reference_models_load_into_both_packages_alike(tmp_path, fourier):
    paths = write_models(tmp_path, fourier)
    sd = _import(paths, fourier, True, torch_import)
    model = CascadedAE(tc.ModelConfig(**MODEL, fourier_variant=fourier))
    model.load_state_dict(sd, strict=True)       # the files' keys are the model's
    params = _import(paths, fourier, True, jimport)

    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 128, 128, 4)).astype(np.float32)
    uv = (rng.normal(size=(2, 2)) * 300).astype(np.float32)
    with torch.no_grad():
        out = model(torch.from_numpy(x), torch.from_numpy(uv))
    jmodel = JCascadedAE(cfg=JModelConfig(**MODEL, fourier_variant=fourier))
    want = jax.jit(jmodel.apply)(params, jnp.asarray(x), jnp.asarray(uv))
    for name in ("xrecon", "Mu", "x1"):
        assert _rel(getattr(out, name).numpy(), np.asarray(getattr(want, name))) < 1e-5, name


@pytest.mark.parametrize("fourier", [False, True], ids=["cascade", "fourier"])
def test_reference_import_without_rica(tmp_path, fourier):
    """rica=False leaves the files' fc2in/fc2out out, as the JAX importer does: the
    state dict loads strictly into a model without RICA and carries the same weights
    as the JAX tree."""
    from lshm_tpu_torch.params import from_flax

    paths = write_models(tmp_path, fourier, seed=2)
    sd = _import(paths, fourier, False, torch_import)
    assert not any(".fc2in." in k or ".fc2out." in k for k in sd)
    CascadedAE(tc.ModelConfig(**MODEL, fourier_variant=fourier, rica=False)).load_state_dict(
        sd, strict=True)
    want = from_flax(_import(paths, fourier, False, jimport))
    assert sd.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_array_equal(sd[k].numpy(), v, err_msg=k)


def test_trainer_loads_imported_models_params_only(tmp_path):
    """An imported model saved as a params-only checkpoint: ``Trainer.load`` takes the
    parameters, records no position and no optimizer, and training starts from them."""
    paths = write_models(tmp_path, fourier=False, seed=3)
    sd = _import(paths, False, True, torch_import)
    ckpt = str(tmp_path / "imported")
    save_checkpoint(ckpt, {"params": sd}, step=0,
                    extras={"source": "torch-reference", "fourier_variant": False})
    cfg = tc.Config(data=tc.DataConfig(batch_size=2, prefetch=0),
                    model=tc.ModelConfig(**MODEL),
                    train=tc.TrainConfig(num_epochs=1, iters_per_epoch=1, admm_iters=1))
    t = Trainer(cfg, device="cpu", logger=MetricLogger(echo=False))
    t.load(ckpt)
    assert t._opt_kind is None and (t._resume_epoch, t._resume_iter) == (0, 0)
    for k, v in sd.items():
        assert torch.equal(t.model.state_dict()[k], v), k
    from lshm_tpu_torch.data import MinibatchSampler, synth_extract

    tree = synth_extract(nstations=4, ntime=192, nfreq=192, seed=7)
    summary = t.run(MinibatchSampler([tree], ["0"], cfg.data, seed=0))
    assert np.isfinite(summary["loss"]) and t._opt_kind == ("adam", "all")

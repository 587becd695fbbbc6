"""Import the reference implementation's PyTorch checkpoints (port of
``lshm_tpu/utils/torch_import.py``).

The reference saves one file per module, each ``{'model_state_dict': OrderedDict}``:
``net.model`` (the 2D AE), ``netT.model`` / ``netF.model`` (the 1D AEs) and
``khm.model`` (the centroids) (reference: src/kharmonic_lofar.py:210-222); the
notebook-era Fourier models ship ``net.model``, ``fnet.model`` and ``khm.model``
(reference: Demo.ipynb cell 6).  The port stores weights in the reference's own
layouts (``lshm_tpu_torch/params.py``), so an import only prefixes the key names with
the submodule they belong to: ``conv0.weight`` of ``net.model`` becomes
``ae2d.conv0.weight``.  The result loads with ``CascadedAE.load_state_dict`` (strict:
the files' keys must match the model's exactly), or into a checkpoint that
``Trainer.load`` takes params-only.
"""

from __future__ import annotations

import torch

_RICA_ONLY = ("fc2in.", "fc2out.")


def _load_state_dict(path: str) -> dict[str, torch.Tensor]:
    return torch.load(path, map_location="cpu", weights_only=True)["model_state_dict"]


def _prefixed(path: str, prefix: str, rica: bool) -> dict[str, torch.Tensor]:
    """``path``'s state dict under ``prefix``; without RICA the files' ``fc2in`` and
    ``fc2out`` layers are left out."""
    return {f"{prefix}.{k}": v for k, v in _load_state_dict(path).items()
            if rica or not k.startswith(_RICA_ONLY)}


def _khm(path: str) -> dict[str, torch.Tensor]:
    return {"khm.M": _load_state_dict(path)["M"]}


def load_reference_checkpoints(net_path: str, netT_path: str, netF_path: str,
                               khm_path: str, rica: bool = True) -> dict[str, torch.Tensor]:
    """The cascade's state dict (``ae2d``, ``aeT``, ``aeF``, ``khm``) from the
    reference's four ``.model`` files."""
    return {**_prefixed(net_path, "ae2d", rica), **_prefixed(netT_path, "aeT", rica),
            **_prefixed(netF_path, "aeF", rica), **_khm(khm_path)}


def load_reference_checkpoints_fourier(net_path: str, fnet_path: str, khm_path: str,
                                       rica: bool = True) -> dict[str, torch.Tensor]:
    """The legacy Fourier cascade's state dict (``ae2d``, ``aef``, ``khm``) from
    ``net.model``, ``fnet.model`` and ``khm.model``."""
    return {**_prefixed(net_path, "ae2d", rica), **_prefixed(fnet_path, "aef", rica),
            **_khm(khm_path)}

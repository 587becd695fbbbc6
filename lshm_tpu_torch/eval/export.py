"""Serving export: the trained cascade forward as a ``torch.export`` artifact with the
parameters in the program (port of ``lshm_tpu/eval/export.py``).

One self-contained artifact carries ``(patches, uv) -> (xrecon, Mu, cluster
distances)``; a process that imports ``lshm_tpu_torch`` (for the K3 operator's
registration) loads and calls it with no model code and no checkpoint.  K3 stays in the
program as the registered operator ``lshm_tpu_torch::head_fwd``
(``kernels/conv_head.py``), so the loaded program launches the kernel on the card.  By
default the batch dimension is symbolic, so one artifact serves any batch size.
"""

from __future__ import annotations

import io

import torch
from torch import nn

from lshm_tpu_torch.losses import pairwise_sq_dists


class _Forward(nn.Module):
    def __init__(self, model: nn.Module, order: int):
        super().__init__()
        self.model = model
        self.order = order

    def forward(self, x: torch.Tensor, uv: torch.Tensor):
        out = self.model(x, uv)
        d2 = pairwise_sq_dists(out.Mu, self.model.khm.M)
        if self.order % 2 == 0:
            dists = d2 ** (self.order // 2)
        else:
            dists = torch.sqrt(d2 + 1e-30) ** self.order
        return out.xrecon, out.Mu, dists


def export_forward(model: nn.Module, patch_size: int = 128, num_channels: int = 4,
                   order: int = 4, batch_size: int | None = None) -> bytes:
    """The bytes of ``torch.export.save`` for ``(x [N, P, P, C], uv [N, 2]) ->
    (xrecon, Mu, dists [N, K])``, float32, traced on the device the model's parameters
    are on, which the artifact keeps.  ``batch_size=None`` makes N a
    ``torch.export.Dim``.  The JAX function's ``params`` argument is gone: the module
    holds its weights."""
    device = next(model.parameters()).device
    n = batch_size or 2                 # a symbolic batch is traced at an example of 2
    x = torch.zeros((n, patch_size, patch_size, num_channels), device=device)
    uv = torch.zeros((n, 2), device=device)
    dynamic = None
    if batch_size is None:
        b = torch.export.Dim("batch")
        dynamic = {"x": {0: b}, "uv": {0: b}}
    program = torch.export.export(_Forward(model, order), (x, uv), dynamic_shapes=dynamic)
    buf = io.BytesIO()
    torch.export.save(program, buf)
    return buf.getvalue()


def load_exported(blob: bytes) -> torch.fx.GraphModule:
    """Deserialize an exported forward; returns the program as a module, callable as
    (x, uv) -> (xrecon, Mu, dists), its parameters frozen (``graph`` shows its
    operators)."""
    import lshm_tpu_torch.kernels.conv_head  # noqa: F401  (registers the K3 operator)

    return torch.export.load(io.BytesIO(blob)).module().requires_grad_(False)

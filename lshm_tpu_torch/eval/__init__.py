from lshm_tpu_torch.eval.clustering import (
    EvalResult,
    baseline_distance_matrix,
    evaluate_sap,
    nmi,
    save_recon_panels,
)
from lshm_tpu_torch.eval.export import export_forward, load_exported

__all__ = [
    "EvalResult",
    "baseline_distance_matrix",
    "evaluate_sap",
    "nmi",
    "save_recon_panels",
    "export_forward",
    "load_exported",
]

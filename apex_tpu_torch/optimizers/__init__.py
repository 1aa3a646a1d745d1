"""apex_tpu_torch.optimizers — the port of ``apex_tpu/optimizers``
(FusedAdam, per-tensor layout)."""

from .fused_adam import FusedAdam  # noqa: F401

"""apex_tpu_torch.amp — opt-level cast policies (serving subset: O0, O3)."""

from .policy import Policy, resolve_policy  # noqa: F401

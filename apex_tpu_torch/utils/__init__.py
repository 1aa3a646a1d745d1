"""apex_tpu_torch.utils — the port of ``apex_tpu/utils`` (``flatten`` /
``unflatten`` so far)."""

from .pytree import flatten, unflatten  # noqa: F401

"""Package-wide logging for ``apex_tpu_torch``.

The same two-function surface as ``apex_tpu/log_util.py``
(``get_logger`` / ``set_logging_level``), kept as the port's own copy so
the port imports nothing of the JAX package: every subsystem logs under
the ``apex_tpu_torch`` namespace instead of printing.
"""

from __future__ import annotations

import logging

__all__ = ["get_logger", "set_logging_level"]

_ROOT = "apex_tpu_torch"

# Visible-by-default diagnostics: one stderr handler at INFO unless the
# embedding application already installed its own; propagation stays off
# so an app-level basicConfig doesn't double-print.
_root_logger = logging.getLogger(_ROOT)
if not _root_logger.handlers:
    _handler = logging.StreamHandler()
    _handler.setFormatter(logging.Formatter("%(name)s: %(message)s"))
    _root_logger.addHandler(_handler)
    _root_logger.setLevel(logging.INFO)
    _root_logger.propagate = False


def get_logger(name: str = "") -> logging.Logger:
    """Logger under the ``apex_tpu_torch`` namespace:
    ``get_logger("serving")`` → ``apex_tpu_torch.serving``; no argument →
    the root package logger."""
    return logging.getLogger(f"{_ROOT}.{name}" if name else _ROOT)


def set_logging_level(verbosity) -> None:
    """Set the package root logger level (ints or level names)."""
    logging.getLogger(_ROOT).setLevel(verbosity)

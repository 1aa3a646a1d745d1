"""apex_tpu_torch — the PyTorch / CUDA port of ``apex_tpu`` for Hopper.

A package of its own beside the JAX package, keeping its module paths so
each port module sits at the same place as its reference:

- ``kernels`` — hand-written CUDA kernels for ``sm_90a`` (``csrc/``),
  built with ``nvcc`` at first use and bound with ``ctypes``, each beside
  its plain PyTorch version;
- ``normalization``, ``amp``, ``models`` and ``serving`` — the paged
  serving path of ``TransformerLM`` (chunked scheduler, paged engine,
  page pool);
- ``amp`` (O0/O2 policies, the dynamic loss scaler, ``make_train_step``),
  ``optimizers`` (FusedAdam) and ``examples.lm.main_amp`` — the training
  path of ``TransformerLM`` with the fused LM-head loss.

The port imports ``torch`` and never ``jax``, ``flax``, ``optax`` or
``apex_tpu``. Entry points run on the GPU unless the caller passes
``device="cpu"``; on CPU tensors every kernel wrapper takes its plain
PyTorch version, on CUDA tensors it launches the kernel or raises.
"""

__version__ = "0.1.0"

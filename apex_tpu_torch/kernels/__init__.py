"""apex_tpu_torch.kernels — hand-written CUDA kernels for Hopper.

The port of ``apex_tpu/kernels``. Every kernel:

- is CUDA C++ for ``sm_90a`` under ``apex_tpu_torch/csrc``, built at
  first use by :mod:`._build` and bound with ``ctypes``;
- accumulates in fp32 whatever its I/O dtype;
- has a plain PyTorch version beside it (the ``*_reference`` functions),
  which its wrapper takes ONLY for tensors on the CPU — on a CUDA tensor
  the wrapper launches the kernel or raises, it never falls back;
- counts its launches in :data:`launches` (one per kernel launch, in the
  wrapper, nowhere else), so a run can show that its path went through
  the kernel.
"""

from __future__ import annotations

import collections

import torch

#: launches per kernel since the last :func:`reset_launches`, keyed by
#: kernel name (``layer_norm``, ``layer_norm_bwd``,
#: ``paged_decode_attention``, ``paged_prefill_attention``, ``flash_fwd``,
#: ``flash_bwd_dkdv``, ``flash_bwd_dq``, ``xent_fwd``, ``xent_bwd``,
#: ``multi_tensor_scale``, ``multi_tensor_adam``)
launches: collections.Counter = collections.Counter()


def reset_launches() -> None:
    """Zero every kernel's launch count."""
    launches.clear()


def on_cuda() -> bool:
    """True when torch sees a CUDA device — the port's counterpart of
    ``apex_tpu.kernels.on_tpu``."""
    return torch.cuda.is_available()


def kernel_route(name: str, *tensors) -> bool:
    """The dispatch rule every wrapper shares: False (take the plain
    version) when every tensor is on the CPU, True (launch the kernel)
    when every tensor is on a CUDA device; anything else raises."""
    devs = {t.device.type for t in tensors if t is not None}
    if devs == {"cpu"}:
        return False
    if devs == {"cuda"}:
        return True
    raise ValueError(f"{name}: tensors on {sorted(devs)} — the kernel "
                     "takes CUDA tensors, its plain version CPU tensors")


def check_launch(name: str, err: int) -> None:
    """Raise when a C entry point reported a refused shape (-1) or a
    non-zero ``cudaGetLastError()`` after its launch."""
    if err == -1:
        raise ValueError(f"{name}: the CUDA kernel refused these shapes")
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed "
                           f"(cudaError_t {err})")


def stream_handle() -> int:
    """The current CUDA stream as an integer handle for ``ctypes``."""
    return torch.cuda.current_stream().cuda_stream


from .layer_norm import (  # noqa: E402,F401
    layer_norm, layer_norm_bwd_reference, layer_norm_reference, rms_norm,
    rms_norm_reference)
from .decode_attention import (  # noqa: E402,F401
    decode_attention_reference, gather_pages, paged_decode_attention,
    paged_decode_attention_reference)
from .prefill_attention import (  # noqa: E402,F401
    paged_prefill_attention, paged_prefill_attention_reference,
    prefill_attention_reference)
from .flash_attention import (  # noqa: E402,F401
    flash_attention, flash_bwd_reference, flash_fwd_reference,
    mha_reference)
from .xentropy import (  # noqa: E402,F401
    softmax_cross_entropy_loss, xent_bwd_reference, xent_fwd_reference,
    xent_reference)
from .multi_tensor import (  # noqa: E402,F401
    adam_tree_step, fused_adam_step, fused_scale, multi_tensor_adam_,
    multi_tensor_scale_)
from .lm_head_loss import (  # noqa: E402,F401
    lm_head_xent_reference, lm_head_xentropy)

"""Carry TransformerLM weights between ``apex_tpu`` and the port.

:func:`params_from_jax` takes the JAX parameter tree as nested dicts of
numpy arrays (the caller converts with ``jax.device_get`` /
``np.asarray``; nothing here imports JAX) and returns a ``state_dict``
for :class:`~apex_tpu_torch.models.transformer_lm.TransformerLM`;
:func:`params_to_jax` is its inverse, so both sides can start from the
same fp32 weights whichever initialised them, and a trained port model
(or its gradients, keyed like its parameters) can be compared leaf by
leaf with the JAX tree:

- a flax ``Dense.kernel`` ``[in, out]`` becomes ``Linear.weight``
  ``[out, in]`` (the ``qkv`` column order ``[3][heads][head_dim]`` is
  kept, so the port splits q/k/v exactly as the reference does);
- ``wte.embedding``, ``wpe`` and the LayerNorm ``scale``/``bias`` carry
  over as they are.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

__all__ = ["params_from_jax", "params_to_jax"]

_DENSE = {"qkv": "attn.qkv", "proj": "attn.proj", "mlp_in": "mlp_in",
          "mlp_out": "mlp_out"}
_NORMS = ("ln_attn", "ln_mlp")


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def _ln(tree: Mapping) -> Dict[str, torch.Tensor]:
    return {"weight": _t(tree["scale"]), "bias": _t(tree["bias"])}


def params_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """The port's ``state_dict`` (fp32 CPU tensors) for a JAX
    ``TransformerLM`` parameter tree ``params`` (nested dicts of numpy
    arrays; a top-level ``{"params": ...}`` wrapper is accepted)."""
    if "params" in params and "wte" not in params:
        params = params["params"]
    sd = {"wte.weight": _t(params["wte"]["embedding"]),
          "wpe": _t(params["wpe"])}
    blocks = sorted(int(m.group(1)) for k in params
                    if (m := re.fullmatch(r"block_(\d+)", k)))
    if blocks != list(range(len(blocks))):
        raise ValueError(f"block indices {blocks} are not 0..n-1")
    for i in blocks:
        tree = params[f"block_{i}"]
        for norm in _NORMS:
            for k, v in _ln(tree[norm]).items():
                sd[f"blocks.{i}.{norm}.{k}"] = v
        for src, dst in _DENSE.items():
            dense = tree["attn"][src] if dst.startswith("attn.") \
                else tree[src]
            sd[f"blocks.{i}.{dst}.weight"] = _t(dense["kernel"]).t() \
                .contiguous()
            sd[f"blocks.{i}.{dst}.bias"] = _t(dense["bias"])
    for k, v in _ln(params["ln_f"]).items():
        sd[f"ln_f.{k}"] = v
    return sd


def _np(t) -> np.ndarray:
    return t.detach().to("cpu", torch.float32).numpy().copy()


def params_to_jax(state: Mapping[str, torch.Tensor]) -> Dict:
    """The JAX ``TransformerLM`` parameter tree (nested dicts of fp32
    numpy arrays, no ``{"params": ...}`` wrapper) for a port
    ``state_dict`` — or any mapping keyed like one, such as parameter
    gradients. Raises when a key is left unmapped."""
    left = set(state)
    tree: Dict = {}

    def take(key):
        left.discard(key)
        return _np(state[key])

    tree["wte"] = {"embedding": take("wte.weight")}
    tree["wpe"] = take("wpe")
    blocks = sorted({int(m.group(1)) for k in state
                     if (m := re.match(r"blocks\.(\d+)\.", k))})
    for i in blocks:
        blk: Dict = {"attn": {}}
        for norm in _NORMS:
            blk[norm] = {"scale": take(f"blocks.{i}.{norm}.weight"),
                         "bias": take(f"blocks.{i}.{norm}.bias")}
        for src, dst in _DENSE.items():
            dense = {"kernel": take(f"blocks.{i}.{dst}.weight").T.copy(),
                     "bias": take(f"blocks.{i}.{dst}.bias")}
            if dst.startswith("attn."):
                blk["attn"][src] = dense
            else:
                blk[src] = dense
        tree[f"block_{i}"] = blk
    tree["ln_f"] = {"scale": take("ln_f.weight"), "bias": take("ln_f.bias")}
    if left:
        raise ValueError(f"params_to_jax: unmapped keys {sorted(left)}")
    return tree

"""apex_tpu_torch.models — the serving modes of TransformerLM."""

from .convert import params_from_jax  # noqa: F401
from .transformer_lm import (  # noqa: F401
    SelfAttention, TransformerBlock, TransformerLM, create_lm)

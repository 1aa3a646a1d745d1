"""apex_tpu_torch.models — TransformerLM: its training forward and its
paged serving modes."""

from .convert import params_from_jax, params_to_jax  # noqa: F401
from .transformer_lm import (  # noqa: F401
    SelfAttention, TransformerBlock, TransformerLM, create_lm)

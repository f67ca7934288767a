"""Model layers in PyTorch, mirroring ``repro.models``."""
from repro_torch.models.lm import (  # noqa: F401
    decode_tokens, init_lm_cache, init_lm_params, lm_decode_step, lm_prefill,
    lm_prefill_chunk, model_param_defs, prepare_params,
)

"""llava-next-mistral-7b — Mistral-7B backbone + anyres vision tiling.
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]  32L d_model=4096 32H
(kv=8) d_ff=14336 vocab=32000.  The vision tower is a stub: the model
takes 576 precomputed 1024-d CLIP patch embeddings, projected and
prepended to the token stream (early fusion)."""
from repro_torch.core.config import AttnConfig, ModelConfig
from repro_torch.core.registry import register

CONFIG = register(ModelConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    n_layers=32,
    d_model=4096,
    d_ff=14336,
    vocab_size=32000,
    attn=AttnConfig(n_heads=32, n_kv_heads=8, head_dim=128,
                    rope_theta=1_000_000.0),
    layer_pattern=("dense",),
    frontend="vision",
    frontend_feature_dim=1024,
), tags=("assigned", "vlm"))

"""smollm-135m — llama-architecture small model.
[hf:HuggingFaceTB/SmolLM-135M; hf]  30L d_model=576 9H (kv=3) d_ff=1536
vocab=49152, head_dim 64, tied embeddings."""
from repro_torch.core.config import AttnConfig, ModelConfig
from repro_torch.core.registry import register

CONFIG = register(ModelConfig(
    name="smollm-135m",
    family="dense",
    n_layers=30,
    d_model=576,
    d_ff=1536,
    vocab_size=49152,
    attn=AttnConfig(n_heads=9, n_kv_heads=3, head_dim=64,
                    rope_theta=10_000.0),
    layer_pattern=("dense",),
    tie_embeddings=True,
), tags=("assigned", "dense"))

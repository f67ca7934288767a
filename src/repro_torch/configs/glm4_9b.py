"""glm4-9b — dense decoder, RoPE + GQA (kv=2).
[hf:THUDM/glm-4-9b; hf]  40L d_model=4096 32H (kv=2) d_ff=13696
vocab=151552: 16 query heads per KV head."""
from repro_torch.core.config import AttnConfig, ModelConfig
from repro_torch.core.registry import register

CONFIG = register(ModelConfig(
    name="glm4-9b",
    family="dense",
    n_layers=40,
    d_model=4096,
    d_ff=13696,
    vocab_size=151552,
    attn=AttnConfig(n_heads=32, n_kv_heads=2, head_dim=128,
                    rope_theta=10_000.0),
    layer_pattern=("dense",),
), tags=("assigned", "dense"))

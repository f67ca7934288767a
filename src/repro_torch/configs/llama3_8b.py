"""llama3-8b — dense decoder, GQA, 128K vocab.
[arXiv:2407.21783; unverified]  32L d_model=4096 32H (kv=8) d_ff=14336
vocab=128256."""
from repro_torch.core.config import AttnConfig, ModelConfig
from repro_torch.core.registry import register

CONFIG = register(ModelConfig(
    name="llama3-8b",
    family="dense",
    n_layers=32,
    d_model=4096,
    d_ff=14336,
    vocab_size=128256,
    attn=AttnConfig(n_heads=32, n_kv_heads=8, head_dim=128,
                    rope_theta=500_000.0),
    layer_pattern=("dense",),
), tags=("assigned", "dense"))

"""zamba2-2.7b — Mamba2 backbone + shared attention blocks.
[arXiv:2411.15242; hf]  54L d_model=2560 32H (kv=32) d_ff=10240 vocab=32000,
ssm_state=64.  The shared transformer block (one weight copy) is applied at
every 6th layer position, Zamba2-style."""
from repro_torch.core.config import AttnConfig, ModelConfig, SSMConfig
from repro_torch.core.registry import register

CONFIG = register(ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    d_ff=10240,
    vocab_size=32000,
    ssm=SSMConfig(d_state=64, headdim=64, expand=2, n_groups=1, chunk=128),
    layer_pattern=("mamba2",) * 5 + ("mamba2+shared",),
    shared_attn=AttnConfig(n_heads=32, n_kv_heads=32, head_dim=80,
                           rope_theta=10_000.0),
    shared_attn_d_ff=10240,
    tie_embeddings=True,
), tags=("assigned", "hybrid"))

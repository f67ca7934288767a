"""qwen3-moe-235b-a22b — 128-expert top-8 MoE.
[hf:Qwen/Qwen3-30B-A3B; hf]  94L d_model=4096 64H (kv=4) expert d_ff=1536
vocab=151936, MoE every layer, qk-norm, head_dim=128."""
from repro_torch.core.config import AttnConfig, ModelConfig, MoEConfig
from repro_torch.core.registry import register

CONFIG = register(ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    n_layers=94,
    d_model=4096,
    d_ff=1536,                      # per-expert ff
    vocab_size=151936,
    attn=AttnConfig(n_heads=64, n_kv_heads=4, head_dim=128,
                    rope_theta=1_000_000.0, qk_norm=True),
    moe=MoEConfig(n_experts=128, experts_per_token=8, d_ff_expert=1536,
                  capacity_factor=1.25),
    layer_pattern=("moe",),
), tags=("assigned", "moe"))

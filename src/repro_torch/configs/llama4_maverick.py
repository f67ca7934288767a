"""llama4-maverick-400b-a17b — interleaved MoE (every 2nd layer), top-1
routing with an always-on shared expert, early fusion.
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]  48L d_model=5120 40H
(kv=8) d_ff=8192 vocab=202048, MoE 128e top-1.  The reference also sets
its sharding field ``fsdp``; the port has no mesh and no such field."""
from repro_torch.core.config import AttnConfig, ModelConfig, MoEConfig
from repro_torch.core.registry import register

CONFIG = register(ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    d_ff=8192,
    vocab_size=202048,
    attn=AttnConfig(n_heads=40, n_kv_heads=8, head_dim=128,
                    rope_theta=500_000.0),
    moe=MoEConfig(n_experts=128, experts_per_token=1, d_ff_expert=8192,
                  interleave_step=2, shared_expert=True,
                  capacity_factor=1.25),
    layer_pattern=("dense_moe", "moe"),
), tags=("assigned", "moe"))

"""gemma3-1b — 5:1 local:global attention, 256K vocab, tied embeddings.
[hf:google/gemma-3-1b-pt; unverified]  26L d_model=1152 4H (kv=1)
d_ff=6912 vocab=262144, sliding window 512, head_dim=256.

``segments()`` gives 4 units of (local x5, dense) and a (local, local)
remainder: 22 ``local`` layers over 512-slot ring caches (rope theta 1e4)
and 4 global ``dense`` layers (rope theta 1e6)."""
from repro_torch.core.config import AttnConfig, ModelConfig
from repro_torch.core.registry import register

CONFIG = register(ModelConfig(
    name="gemma3-1b",
    family="dense",
    n_layers=26,
    d_model=1152,
    d_ff=6912,
    vocab_size=262144,
    attn=AttnConfig(n_heads=4, n_kv_heads=1, head_dim=256,
                    rope_theta=1_000_000.0, sliding_window=512),
    layer_pattern=("local", "local", "local", "local", "local", "dense"),
    tie_embeddings=True,
    act="gelu",
), tags=("assigned", "dense", "local-global"))

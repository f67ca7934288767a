"""hubert-xlarge — encoder-only audio transformer backbone.
[arXiv:2106.07447; unverified]  48L d_model=1280 16H (kv=16) d_ff=5120
vocab=504 (masked-prediction cluster targets).  The conv feature extractor
is a stub: the model embeds precomputed 512-d frame features."""
from repro_torch.core.config import AttnConfig, ModelConfig
from repro_torch.core.registry import register

CONFIG = register(ModelConfig(
    name="hubert-xlarge",
    family="audio",
    n_layers=48,
    d_model=1280,
    d_ff=5120,
    vocab_size=504,
    attn=AttnConfig(n_heads=16, n_kv_heads=16, head_dim=80, causal=False),
    layer_pattern=("encoder",),
    frontend="audio",
    frontend_feature_dim=512,
    act="gelu",
), tags=("assigned", "audio", "encoder"))

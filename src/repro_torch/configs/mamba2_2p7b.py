"""mamba2-2.7b — pure SSD (state-space duality), attention-free.
[arXiv:2405.21060]  64L d_model=2560 d_ff=0 vocab=50280, ssm_state=128.
The paper's central subject."""
from repro_torch.core.config import ModelConfig, SSMConfig
from repro_torch.core.registry import register

CONFIG = register(ModelConfig(
    name="mamba2-2.7b",
    family="ssm",
    n_layers=64,
    d_model=2560,
    d_ff=0,
    vocab_size=50280,
    ssm=SSMConfig(d_state=128, headdim=64, expand=2, n_groups=1, chunk=128),
    layer_pattern=("mamba2",),
    tie_embeddings=True,
), tags=("assigned", "ssm"))

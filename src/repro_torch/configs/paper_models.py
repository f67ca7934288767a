"""The paper's own model suite (Table II): the entries of the reference's
``configs/paper_models.py``, field for field.  Falcon-H1-0.5B and
Hymba-1.5B are ``hybrid_par`` models: attention and a Mamba-2 mixer side
by side in every layer, both reading one normed input.

mamba-130m is the only Mamba-1 model: 24 ``mamba1`` layers, d_model 768
(d_inner 1536), d_state 16, dt_rank ceil(768/16) = 48, conv kernel 4,
vocab 50280 padded to 50432, tied embeddings.
"""
from repro_torch.core.config import AttnConfig, ModelConfig, SSMConfig
from repro_torch.core.registry import register

QWEN25_05B = register(ModelConfig(
    name="qwen2.5-0.5b", family="dense", n_layers=24, d_model=896,
    d_ff=4864, vocab_size=151936,
    attn=AttnConfig(n_heads=14, n_kv_heads=2, head_dim=64,
                    rope_theta=1_000_000.0),
    layer_pattern=("dense",), tie_embeddings=True,
), tags=("paper", "dense"))

QWEN25_15B = register(ModelConfig(
    name="qwen2.5-1.5b", family="dense", n_layers=28, d_model=1536,
    d_ff=8960, vocab_size=151936,
    attn=AttnConfig(n_heads=12, n_kv_heads=2, head_dim=128,
                    rope_theta=1_000_000.0),
    layer_pattern=("dense",), tie_embeddings=True,
), tags=("paper", "dense"))

LLAMA32_1B = register(ModelConfig(
    name="llama3.2-1b", family="dense", n_layers=16, d_model=2048,
    d_ff=8192, vocab_size=128256,
    attn=AttnConfig(n_heads=32, n_kv_heads=8, head_dim=64,
                    rope_theta=500_000.0),
    layer_pattern=("dense",), tie_embeddings=True,
), tags=("paper", "dense"))

PHI3_MINI = register(ModelConfig(
    name="phi-3-mini", family="dense", n_layers=32, d_model=3072,
    d_ff=8192, vocab_size=32064,
    attn=AttnConfig(n_heads=32, n_kv_heads=32, head_dim=96),
    layer_pattern=("dense",),
), tags=("paper", "dense"))

MAMBA1_130M = register(ModelConfig(
    name="mamba-130m", family="ssm", n_layers=24, d_model=768, d_ff=0,
    vocab_size=50280,
    ssm=SSMConfig(d_state=16, variant="mamba1", expand=2, conv_kernel=4),
    layer_pattern=("mamba1",), tie_embeddings=True,
), tags=("paper", "ssm", "mamba1"))

MAMBA2_130M = register(ModelConfig(
    name="mamba2-130m", family="ssm", n_layers=24, d_model=768, d_ff=0,
    vocab_size=50280,
    ssm=SSMConfig(d_state=128, headdim=64, expand=2, n_groups=1, chunk=128),
    layer_pattern=("mamba2",), tie_embeddings=True,
), tags=("paper", "ssm"))

MAMBA2_780M = register(ModelConfig(
    name="mamba2-780m", family="ssm", n_layers=48, d_model=1536, d_ff=0,
    vocab_size=50280,
    ssm=SSMConfig(d_state=128, headdim=64, expand=2, n_groups=1, chunk=128),
    layer_pattern=("mamba2",), tie_embeddings=True,
), tags=("paper", "ssm"))

# Falcon-H1-0.5B: parallel hybrid heads (attention + Mamba-2 side by side
# in every layer — the real Falcon-H1 topology via the hybrid_par block).
FALCON_H1_05B = register(ModelConfig(
    name="falcon-h1-0.5b", family="hybrid", n_layers=18, d_model=1024,
    d_ff=4096, vocab_size=32784,
    attn=AttnConfig(n_heads=8, n_kv_heads=4, head_dim=128),
    ssm=SSMConfig(d_state=128, headdim=64, expand=2, n_groups=1, chunk=128),
    layer_pattern=("hybrid_par",), tie_embeddings=True,
), tags=("paper", "hybrid"))

# Hymba-1.5B proxy: also a parallel hybrid-head design (attention + SSM
# heads in the same layer).
HYMBA_15B = register(ModelConfig(
    name="hymba-1.5b", family="hybrid", n_layers=24, d_model=1536,
    d_ff=5504, vocab_size=32001,
    attn=AttnConfig(n_heads=12, n_kv_heads=2, head_dim=128),
    ssm=SSMConfig(d_state=128, headdim=64, expand=2, n_groups=1, chunk=128),
    layer_pattern=("hybrid_par",), tie_embeddings=True,
), tags=("paper", "hybrid"))

# Zamba2-1.2B (Fig. 8a): mamba2 backbone + shared attention, no GQA.
ZAMBA2_12B = register(ModelConfig(
    name="zamba2-1.2b", family="hybrid", n_layers=38, d_model=2048,
    d_ff=8192, vocab_size=32000,
    ssm=SSMConfig(d_state=64, headdim=64, expand=2, n_groups=1, chunk=128),
    layer_pattern=("mamba2", "mamba2+shared"),
    # the shared block operates on concat(x, embed) in Zamba2 -> 128-d heads
    shared_attn=AttnConfig(n_heads=32, n_kv_heads=32, head_dim=128),
    shared_attn_d_ff=8192, tie_embeddings=True,
), tags=("paper", "hybrid"))

"""MusicGen-large decoder over EnCodec tokens.

[arXiv:2306.05284] 48L d_model=2048 32H (kv=32, MHA) d_ff=8192
vocab=2048. Cross-attends to a (stubbed) T5 text-conditioning sequence;
the EnCodec conv codec frontend is a stub providing frame embeddings.

The port's own copy of ``repro.configs.musicgen_large``.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    family="audio",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=2048,
    block_pattern=("attn",),
    cross_attn=True,
    cond_len=256,
    input_kind="embeddings",
    mlp_gated=False,
    act="gelu",
    microbatch=32,
    q_chunk=1024,
)

"""Gemma-3 27B: 5 local (sliding window 1024) : 1 global pattern.

[hf:google/gemma-3-1b-pt family] 62L d_model=5376 32H (GQA kv=16)
head_dim=128 d_ff=21504 vocab=262144, tied embeddings, logit softcap.

The port's own copy of ``repro.configs.gemma3_27b``.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-27b",
    family="dense",
    n_layers=62,
    d_model=5376,
    n_heads=32,
    n_kv_heads=16,
    head_dim=128,
    d_ff=21504,
    vocab_size=262144,
    block_pattern=("local", "local", "local", "local", "local", "attn"),
    window=1024,
    tie_embeddings=True,
    embed_scale=True,
    rope_theta=1e6,
    microbatch=16,
    q_chunk=1024,
)

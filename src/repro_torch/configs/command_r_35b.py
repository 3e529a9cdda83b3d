"""Cohere Command-R 35B dense (GQA, no biases).

[hf:CohereForAI/c4ai-command-r-v01] 40L d_model=8192 64H (GQA kv=8)
d_ff=22528 vocab=256000.

The port's own copy of ``repro.configs.command_r_35b``.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="command-r-35b",
    family="dense",
    n_layers=40,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=22528,
    vocab_size=256000,
    block_pattern=("attn",),
    tie_embeddings=True,
    rope_theta=8e6,
    microbatch=16,
    q_chunk=1024,
)

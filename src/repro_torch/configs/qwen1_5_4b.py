"""Qwen1.5 4B dense with QKV bias.

[hf:Qwen/Qwen1.5-0.5B family] 40L d_model=2560 20H (kv=20, MHA)
d_ff=6912 vocab=151936. The port's own copy of
``repro.configs.qwen1_5_4b``.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-4b",
    family="dense",
    n_layers=40,
    d_model=2560,
    n_heads=20,
    n_kv_heads=20,
    head_dim=128,
    d_ff=6912,
    vocab_size=151936,
    block_pattern=("attn",),
    qkv_bias=True,
    microbatch=32,
    q_chunk=1024,
)

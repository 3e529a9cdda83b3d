"""RWKV6 "Finch" 7B — attention-free, data-dependent decay.

[arXiv:2404.05892] 32L d_model=4096 (64 heads x 64) d_ff=14336
vocab=65536. The port's own copy of ``repro.configs.rwkv6_7b``.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b",
    family="ssm",
    n_layers=32,
    d_model=4096,
    n_heads=64,
    n_kv_heads=64,
    head_dim=64,
    d_ff=14336,
    vocab_size=65536,
    block_pattern=("rwkv",),
    pos_kind="none",
    microbatch=16,
)

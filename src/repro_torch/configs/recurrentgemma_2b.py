"""RecurrentGemma 2B (Griffin): RG-LRU + local attention, 1 attn : 2 rec.

[arXiv:2402.19427] 26L d_model=2560 10H (GQA kv=1) head_dim=256
d_ff=7680 vocab=256000, window 2048, conv width 4. The port's own copy
of ``repro.configs.recurrentgemma_2b``.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256000,
    block_pattern=("rec", "rec", "local"),
    window=2048,
    d_rnn=2560,
    conv_width=4,
    tie_embeddings=True,
    embed_scale=True,
    act="gelu",
    microbatch=32,
)

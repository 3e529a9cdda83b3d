"""Qwen2-VL 72B language backbone with M-RoPE.

[arXiv:2409.12191] 80L d_model=8192 64H (GQA kv=8) d_ff=29568
vocab=152064. The ViT encoder/projector is a stub: input_specs provides
combined token/patch embeddings and (3, B, S) M-RoPE position ids.

The port's own copy of ``repro.configs.qwen2_vl_72b``.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=29568,
    vocab_size=152064,
    block_pattern=("attn",),
    pos_kind="mrope",
    mrope_sections=(16, 24, 24),
    qkv_bias=True,
    input_kind="embeddings",
    rope_theta=1e6,
    microbatch=16,
    q_chunk=1024,
)

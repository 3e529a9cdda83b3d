"""Llama-4 Scout 17B-active/16-expert MoE (early fusion; text backbone).

[hf:meta-llama/Llama-4-Scout-17B-16E] 48L d_model=5120 40H (GQA kv=8)
d_ff=8192 vocab=202048, MoE 16 experts top-1 + shared expert.

The port's own copy of ``repro.configs.llama4_scout``.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202048,
    block_pattern=("moe",),
    n_experts=16,
    top_k=1,
    shared_expert=True,
    rope_theta=5e5,
    # the reference's sharded-training choice, kept for asdict parity
    microbatch=32,
    q_chunk=1024,
)

"""Snowflake Arctic (480B-class dense-MoE hybrid).

[hf:Snowflake/snowflake-arctic-base] 35L d_model=7168 56H (GQA kv=8)
d_ff=4864 vocab=32000, MoE 128 experts top-2 with a parallel dense
residual FFN per layer.

The port's own copy of ``repro.configs.arctic_480b``.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,
    d_ff=4864,
    vocab_size=32000,
    block_pattern=("moe",),
    n_experts=128,
    top_k=2,
    moe_dense_residual=True,
    rope_theta=1e6,
    # the reference's sharded-training choices, kept for asdict parity
    microbatch=32,
    accum_dtype="bfloat16",
    q_chunk=1024,
)

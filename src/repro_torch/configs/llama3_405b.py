"""Llama-3.1 405B dense.

[arXiv:2407.21783] 126L d_model=16384 128H (GQA kv=8) d_ff=53248
vocab=128256.

The port's own copy of ``repro.configs.llama3_405b``.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama3-405b",
    family="dense",
    n_layers=126,
    d_model=16384,
    n_heads=128,
    n_kv_heads=8,
    head_dim=128,
    d_ff=53248,
    vocab_size=128256,
    block_pattern=("attn",),
    rope_theta=5e5,
    # the reference's sharded-training choices, kept for asdict parity
    microbatch=64,
    seq_parallel=True,
    q_chunk=1024,
    opt_state_dtype="bfloat16",
    accum_dtype="bfloat16",
)

"""Architecture configuration for the model substrate.

The port's own copy of ``repro.models.config``: one `ModelConfig` fully
describes an architecture; ``repro_torch/configs/<arch>.py`` files
instantiate the architectures the port has taken over. Every field and
``reduced()`` are the reference's; the dtype properties give torch
dtypes.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # dense|moe|ssm|hybrid|vlm|audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                 # 0 => d_model // n_heads

    # Block pattern, cycled across the stack. Kinds:
    #   "attn"  global attention + FFN        "local" windowed attn + FFN
    #   "moe"   attention + MoE FFN           "rwkv"  RWKV6 time+channel mix
    #   "rec"   RG-LRU recurrent block + FFN
    block_pattern: Tuple[str, ...] = ("attn",)
    window: int = 0                   # sliding window for "local" blocks

    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    moe_dense_residual: bool = False  # arctic: dense FFN in parallel
    shared_expert: bool = False       # llama4: always-on shared expert
    router_aux_weight: float = 0.01
    router_z_weight: float = 1e-3

    # Attention details
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    pos_kind: str = "rope"            # rope|mrope|none
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)
    cross_attn: bool = False          # musicgen: cross-attend to conditioning
    cond_len: int = 256               # conditioning sequence length
    logit_softcap: float = 0.0

    # Inputs
    input_kind: str = "tokens"        # tokens | embeddings (audio/vlm stubs)

    # FFN / embedding details
    act: str = "silu"
    mlp_gated: bool = True
    tie_embeddings: bool = False
    embed_scale: bool = False         # gemma-style sqrt(d_model) scaling
    norm_eps: float = 1e-6

    # SSM / hybrid
    conv_width: int = 4
    d_rnn: int = 0                    # 0 => d_model
    rg_lru_c: float = 8.0

    # Numerics & training
    dtype: str = "bfloat16"           # activation/compute dtype
    param_dtype: str = "bfloat16"     # stored parameter dtype
    opt_state_dtype: str = "float32"  # AdamW m/v dtype (bf16 for 405B)
    accum_dtype: str = "float32"      # grad-accumulation dtype
    remat: bool = True
    seq_parallel: bool = False        # shard boundary activations' seq dim
    microbatch: int = 0               # >0: grad accumulation chunk size
    q_chunk: int = 0                  # >0: chunk queries in attention
    gla_chunk: int = 16               # RWKV6 chunked-scan chunk size

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.d_rnn == 0:
            object.__setattr__(self, "d_rnn", self.d_model)
        assert self.n_heads % max(self.n_kv_heads, 1) == 0

    # ---- derived ----
    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def param_torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    @property
    def cycle_len(self) -> int:
        return len(self.block_pattern)

    @property
    def n_cycles(self) -> int:
        return self.n_layers // self.cycle_len

    @property
    def n_rem(self) -> int:
        return self.n_layers % self.cycle_len

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // self.n_kv_heads

    def reduced(self, **overrides) -> "ModelConfig":
        """Smoke-test variant: same family/blocks, tiny dimensions."""
        d_model = min(self.d_model, 256)
        n_heads = min(self.n_heads, 4)
        n_kv = max(1, min(self.n_kv_heads, n_heads))
        while n_heads % n_kv:
            n_kv -= 1
        cyc = self.cycle_len
        base = dict(
            name=self.name + "-smoke",
            n_layers=max(2, min(cyc, 3)),
            d_model=d_model,
            n_heads=n_heads,
            n_kv_heads=n_kv,
            head_dim=64,
            d_ff=min(self.d_ff, 512),
            vocab_size=min(self.vocab_size, 512),
            n_experts=min(self.n_experts, 4),
            top_k=min(self.top_k, 2),
            window=min(self.window, 64) if self.window else 0,
            cond_len=32,
            d_rnn=min(self.d_rnn, 256),
            mrope_sections=(8, 12, 12),  # sums to 64/2 for head_dim 64
            param_dtype="float32",
            dtype="float32",
            microbatch=0,
            q_chunk=0,
            remat=False,
        )
        # keep at least one full pattern cycle so every block kind is hit
        if cyc > base["n_layers"]:
            base["n_layers"] = cyc
        base.update(overrides)
        return dataclasses.replace(self, **base)


@dataclasses.dataclass(frozen=True)
class InputShape:
    """One of the four assigned global input shapes."""
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # train | prefill | decode


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}

"""Model configurations of the port and the architecture registry:
``--arch <id>`` resolves here. The registry holds the reference's ten
architectures, each config equal to the reference's field for field.
``variant_for_shape``, ``supports_shape`` and ``all_pairs`` are the
reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.configs.arctic_480b import CONFIG as ARCTIC
from repro_torch.configs.command_r_35b import CONFIG as COMMAND_R
from repro_torch.configs.gemma3_27b import CONFIG as GEMMA3
from repro_torch.configs.llama3_405b import CONFIG as LLAMA3
from repro_torch.configs.llama4_scout import CONFIG as LLAMA4
from repro_torch.configs.musicgen_large import CONFIG as MUSICGEN
from repro_torch.configs.qwen1_5_4b import CONFIG as QWEN15
from repro_torch.configs.qwen2_vl_72b import CONFIG as QWEN2VL
from repro_torch.configs.recurrentgemma_2b import CONFIG as RECURRENTGEMMA
from repro_torch.configs.rwkv6_7b import CONFIG as RWKV6
from repro_torch.models.config import INPUT_SHAPES, InputShape, ModelConfig

REGISTRY: Dict[str, ModelConfig] = {
    c.name: c for c in (
        ARCTIC, RWKV6, MUSICGEN, LLAMA4, LLAMA3, GEMMA3, QWEN2VL, QWEN15,
        RECURRENTGEMMA, COMMAND_R)
}

# long_500k requires sub-quadratic attention. SSM/hybrid run natively;
# gemma3 runs an all-local sliding-window VARIANT; pure full-attention
# archs skip.
LONG_CONTEXT_ARCHS = {"rwkv6-7b", "recurrentgemma-2b", "gemma3-27b"}


def get_config(name: str) -> ModelConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(REGISTRY)}")
    return REGISTRY[name]


def supports_shape(cfg: ModelConfig, shape: InputShape) -> bool:
    if shape.name == "long_500k":
        return cfg.name in LONG_CONTEXT_ARCHS
    return True


def variant_for_shape(cfg: ModelConfig, shape: InputShape) -> ModelConfig:
    """Per-shape config adjustments, as in the reference."""
    if shape.name == "long_500k" and cfg.name == "gemma3-27b":
        cfg = dataclasses.replace(
            cfg, block_pattern=("local",), name=cfg.name)
    if shape.kind == "decode":
        # decode never needs grad-accumulation or q-chunking
        cfg = dataclasses.replace(cfg, microbatch=0, q_chunk=0)
    if shape.kind == "prefill":
        cfg = dataclasses.replace(cfg, microbatch=0)
    return cfg


def all_pairs():
    """(name, cfg, shape, supported) for every architecture x input
    shape."""
    for name, cfg in REGISTRY.items():
        for shape in INPUT_SHAPES.values():
            yield name, cfg, shape, supports_shape(cfg, shape)


__all__ = ["INPUT_SHAPES", "REGISTRY", "all_pairs", "get_config",
           "supports_shape", "variant_for_shape"]

"""Model configurations of the port and the architecture registry:
``--arch <id>`` resolves here.

Only the architectures the port has taken over are registered. The
reference's other architectures raise ``NotImplementedError``: they
wait for later slices of the port (ROADMAP.md, Queue 1).
``variant_for_shape`` and ``supports_shape`` are the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.configs.qwen1_5_4b import CONFIG as QWEN15
from repro_torch.configs.recurrentgemma_2b import CONFIG as RECURRENTGEMMA
from repro_torch.configs.rwkv6_7b import CONFIG as RWKV6
from repro_torch.models.config import INPUT_SHAPES, InputShape, ModelConfig

REGISTRY: Dict[str, ModelConfig] = {c.name: c for c in (QWEN15,
                                                         RECURRENTGEMMA,
                                                         RWKV6)}

# the reference's architectures that the port has not taken over yet
NOT_PORTED = ("arctic-480b", "command-r-35b", "gemma3-27b", "llama3-405b",
              "llama4-scout-17b-a16e", "musicgen-large", "qwen2-vl-72b")

# long_500k requires sub-quadratic attention. SSM/hybrid run natively;
# gemma3 runs an all-local sliding-window VARIANT; pure full-attention
# archs skip.
LONG_CONTEXT_ARCHS = {"rwkv6-7b", "recurrentgemma-2b", "gemma3-27b"}


def get_config(name: str) -> ModelConfig:
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"arch {name!r} is not ported to PyTorch yet (ROADMAP.md, "
            f"Queue 1); the port has {sorted(REGISTRY)}")
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


__all__ = ["INPUT_SHAPES", "REGISTRY", "get_config", "supports_shape",
           "variant_for_shape"]

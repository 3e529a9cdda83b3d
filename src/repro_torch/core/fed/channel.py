"""Channel models for federated uploads (the port of
``repro.core.fed.channel``: the identity channel).

A channel is a callable ``(gen, uploads) -> uploads`` over a list of
stacked update tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class IdentityChannel:
    """Noiseless classical transmission (the paper's assumption)."""

    def __call__(self, gen, uploads):
        del gen
        return uploads


def resolve_channel(upload_noise: float = 0.0,
                    quantize_bits: Optional[int] = None) -> IdentityChannel:
    """The channel a pair of config knobs denotes. Hermitian upload noise
    and quantisation are not in the port yet and are refused."""
    if quantize_bits is not None or upload_noise > 0.0:
        raise NotImplementedError(
            "the port has only the identity channel; upload_noise and "
            "quantize_bits are not ported yet")
    return IdentityChannel()

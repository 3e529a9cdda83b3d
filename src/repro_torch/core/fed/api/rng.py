"""The port's counter-based round keys.

The reference keys every round with a JAX PRNG key (``fold_in(base,
t)``, or a pre-split plan) and derives a retry's key as ``fold_in(key,
attempt)``. The port has no JAX keys: a key here is a plain int in
[0, 2^63), so it is one int64 leaf in a checkpoint, and the draws of a
round come from a FRESH ``torch.Generator`` seeded with the round's key
(``generator``). No generator state is carried from one round to the
next, so a round is a pure function of (checkpointed key, round index)
and kill-and-resume is bit-exact under every scheduler.

The mixing function is SplitMix64's finalizer, applied to the key and
then to the key xor the data. These streams are the port's own: they do
not reproduce the reference's ``jax.random`` streams.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

_MASK64 = (1 << 64) - 1
_MASK63 = (1 << 63) - 1
_SPLIT_TAG = 0x5EED5EED


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def fold_in(key: int, data: int) -> int:
    """A new key, a pure function of ``key`` and the int ``data``."""
    return _splitmix64(_splitmix64(int(key) & _MASK64)
                       ^ (int(data) & _MASK64)) & _MASK63


def split(key: int, num: int = 2) -> List[int]:
    """``num`` keys derived from ``key``, distinct from its ``fold_in``s."""
    base = fold_in(key, _SPLIT_TAG)
    return [fold_in(base, i) for i in range(num)]


def generator(key: int) -> torch.Generator:
    """A fresh CPU generator seeded with ``key``. Every draw of the port's
    round is made on the host (selection) or from this generator's
    stream, whatever device the round runs on."""
    return torch.Generator(device="cpu").manual_seed(int(key))


def from_key_words(words: Sequence[int]) -> int:
    """A key from the words of a reference JAX key (uint32 (2,)), high
    word first: deterministic, but not the reference's stream."""
    key = 0
    for w in np.asarray(words).reshape(-1).tolist():
        key = ((key << 32) | (int(w) & 0xFFFFFFFF)) & _MASK64
    return key & _MASK63

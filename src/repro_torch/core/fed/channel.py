"""Channel models for federated uploads (the port of
``repro.core.fed.channel``).

A channel is a callable ``(gen, uploads) -> uploads`` over a list of
stacked update tensors (quantum) or a dict of stacked deltas
(classical). The Hermitian model perturbs each uploaded
update matrix K with GUE noise scaled relative to ||K||_F:

    K_noisy = K + sigma * ||K||_F * H,   H ~ GUE, ||H||_F = 1

so e^{i eps K_noisy} stays exactly unitary. The quantisation model
simulates a ``bits``-bit uplink: each uploaded tensor is stochastically
rounded (unbiased, E[q(x)] = x) onto a symmetric per-tensor grid of
2^{bits-1}-1 positive levels; complex uploads quantise their real and
imaginary parts with independent draws.

The port draws from a ``torch.Generator`` and does not replay the
reference's keys. Each draw sits beside a draw-free core that takes it
as a tensor (``perturb_with``, ``_round_with``), which is what the
parity tests feed with the reference's own draws.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Protocol

import torch

from repro_torch.optim.tree import tree_map


def _dagger(a: torch.Tensor) -> torch.Tensor:
    return a.transpose(-1, -2).conj()


def _draw(gen: torch.Generator, shape, dtype, device, normal: bool
          ) -> torch.Tensor:
    """Standard normals or uniforms in [0, 1) drawn on the generator's
    device and moved to ``device``."""
    fn = torch.randn if normal else torch.rand
    return fn(tuple(shape), generator=gen, dtype=dtype,
              device=gen.device).to(device)


class ChannelModel(Protocol):
    """Transforms uploads on their way to the server."""

    def __call__(self, gen: torch.Generator, uploads):
        ...


@dataclasses.dataclass(frozen=True)
class IdentityChannel:
    """Noiseless classical transmission (the paper's assumption)."""

    def __call__(self, gen, uploads):
        del gen
        return uploads


@dataclasses.dataclass(frozen=True)
class HermitianNoiseChannel:
    """Relative Hermitian (GUE) noise on each uploaded update matrix."""
    sigma: float

    def __call__(self, gen, uploads):
        return perturb_updates(gen, uploads, self.sigma)


@dataclasses.dataclass(frozen=True)
class QuantizationChannel:
    """Uniform stochastic rounding to a ``bits``-bit symmetric grid."""
    bits: int

    def __post_init__(self):
        if not 2 <= int(self.bits) <= 16:
            raise ValueError(f"quantization bits must be in [2, 16], got "
                             f"{self.bits}")

    def __call__(self, gen, uploads):
        # leaf by leaf in order: a list of layers or a dict of deltas
        return tree_map(lambda x: quantize_with(x, self.bits,
                                                quantize_draws(gen, x)),
                        uploads)


def quantize_draws(gen: torch.Generator, x: torch.Tensor):
    """The uniforms one upload's rounding consumes: one tensor of x's
    shape for a real x, a (real, imaginary) pair for a complex one."""
    rd = x.real.dtype if x.is_complex() else x.dtype
    if x.is_complex():
        return (_draw(gen, x.shape, rd, x.device, False),
                _draw(gen, x.shape, rd, x.device, False))
    return _draw(gen, x.shape, rd, x.device, False)


def quantize_with(x: torch.Tensor, bits: int, u) -> torch.Tensor:
    """Stochastic rounding of one upload from its draws (see
    ``quantize_draws``)."""
    if x.is_complex():
        return torch.complex(_round_with(x.real, bits, u[0]),
                             _round_with(x.imag, bits, u[1]))
    return _round_with(x, bits, u)


def _round_with(x: torch.Tensor, bits: int, u: torch.Tensor
                ) -> torch.Tensor:
    """Unbiased rounding of a real tensor onto its per-tensor grid:
    scale = max|x| / (2^{bits-1}-1); x/scale rounds up where the uniform
    u falls below its fractional part (E[result] = x exactly)."""
    levels = float(2 ** (bits - 1) - 1)
    scale = torch.clamp(torch.max(torch.abs(x)) / levels,
                        min=torch.finfo(x.dtype).tiny)
    y = x / scale
    lo = torch.floor(y)
    up = (u < (y - lo)).to(x.dtype)
    return (lo + up) * scale


def _stochastic_round(gen: torch.Generator, x: torch.Tensor, bits: int
                      ) -> torch.Tensor:
    """``_round_with`` on fresh uniforms of x's shape and dtype."""
    return _round_with(x, bits, _draw(gen, x.shape, x.dtype, x.device,
                                      False))


CHANNELS = ("identity", "hermitian", "quantize")


def make_channel(name: str, sigma: float = 0.0, bits: int = 8
                 ) -> ChannelModel:
    """Channel registry: "identity" | "hermitian" | "quantize"."""
    if name == "identity":
        return IdentityChannel()
    if name == "hermitian":
        return HermitianNoiseChannel(sigma)
    if name == "quantize":
        return QuantizationChannel(bits)
    raise ValueError(f"unknown channel {name!r}; registered: "
                     f"{list(CHANNELS)}")


def resolve_channel(upload_noise: float = 0.0,
                    quantize_bits: Optional[int] = None) -> ChannelModel:
    """The channel a pair of config knobs denotes: quantisation when
    ``quantize_bits`` is set, Hermitian noise when ``upload_noise > 0``,
    identity otherwise. Setting both is refused: one channel per
    federation."""
    if quantize_bits is not None:
        if upload_noise > 0.0:
            raise ValueError("upload_noise and quantize_bits both set — "
                             "a spec names ONE channel model")
        return make_channel("quantize", bits=quantize_bits)
    if upload_noise > 0.0:
        return make_channel("hermitian", sigma=upload_noise)
    return make_channel("identity")


def hermitian_from_gaussian(a: torch.Tensor) -> torch.Tensor:
    """GUE-normalised Hermitian noise from a complex Gaussian draw a:
    (a + a^H) / 2 scaled to unit Frobenius norm per matrix."""
    h = (a + _dagger(a)) / 2.0
    norm = torch.sqrt(torch.sum(torch.abs(h) ** 2, dim=(-2, -1),
                                keepdim=True))
    return h / torch.clamp(norm, min=1e-12)


def gaussian_draw(gen: torch.Generator, shape, dtype, device
                  ) -> torch.Tensor:
    """The complex Gaussian one noise matrix stack consumes: real parts,
    then imaginary parts, standard normal each."""
    rd = dtype.to_real()
    re = _draw(gen, shape, rd, device, True)
    im = _draw(gen, shape, rd, device, True)
    return torch.complex(re, im).to(dtype)


def hermitian_noise(gen: torch.Generator, shape, dtype, device
                    ) -> torch.Tensor:
    """GUE-normalised Hermitian noise with unit Frobenius scale."""
    return hermitian_from_gaussian(gaussian_draw(gen, shape, dtype, device))


def perturb_with(ks: List[torch.Tensor], gaussians: List[torch.Tensor],
                 sigma: float) -> List[torch.Tensor]:
    """Relative Hermitian noise on each stacked update matrix from its
    complex Gaussian draw (``gaussian_draw``)."""
    out = []
    for k, a in zip(ks, gaussians):
        scale = torch.sqrt(torch.sum(torch.abs(k) ** 2, dim=(-2, -1),
                                     keepdim=True))
        out.append(k + sigma * scale * hermitian_from_gaussian(a))
    return out


def perturb_updates(gen: torch.Generator, ks: List[torch.Tensor],
                    sigma: float) -> List[torch.Tensor]:
    """Add relative Hermitian noise to each (stacked) update matrix."""
    return perturb_with(ks, [gaussian_draw(gen, k.shape, k.dtype, k.device)
                             for k in ks], sigma)

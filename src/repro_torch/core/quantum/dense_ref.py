"""Dense full-space path of the dissipative QNN, the port of
``repro.core.quantum.dense_ref``: the seed form of the layer channel,
its adjoint and the Prop.-1 update matrices. Every perceptron unitary
is embedded into the full 2**(m_in+m_out) layer space and applied as a
dense U rho U^H sandwich.

It is the oracle the other engines are held against (to <= 1e-10 in
complex128) and ``engine="dense"`` of ``qnn.update_matrices``.

Node axis: as in ``qnn``, a layer of params may be ``(m, d, d)`` or
``(P, m, d, d)`` with states ``(X, d)`` or ``(P, X, d)``; the Prop.-1
sums run over X only.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from repro_torch.core.quantum import linalg as ql

Params = List[torch.Tensor]


def embedded_perceptrons(us: torch.Tensor, m_in: int, m_out: int
                         ) -> torch.Tensor:
    """Each U^{l,j} of a stack (*B, m_out, d, d) embedded into the full
    (m_in + m_out)-qubit space: (*B, m_out, D, D), D = 2**(m_in+m_out)."""
    n = m_in + m_out
    return torch.stack([ql.embed_unitary(us[..., j, :, :],
                                         list(range(m_in)) + [m_in + j], n)
                        for j in range(m_out)], dim=-3)


def _u(embedded: torch.Tensor, j: int) -> torch.Tensor:
    return embedded[..., j, :, :]


def layer_forward(us: torch.Tensor, rho_in: torch.Tensor, m_in: int,
                  m_out: int) -> torch.Tensor:
    """Apply the layer channel E^l to a (batched) density matrix."""
    n = m_in + m_out
    p0 = ql.zero_projector(m_out, dtype=rho_in.dtype, device=rho_in.device)
    full = torch.einsum("...ab,cd->...acbd", rho_in, p0)
    d = ql.dim(n)
    full = full.reshape(rho_in.shape[:-2] + (d, d))
    embedded = embedded_perceptrons(us, m_in, m_out)
    for j in range(m_out):
        full = ql.apply_unitary(full, _u(embedded, j))
    return ql.partial_trace(full, keep=list(range(m_in, n)), n_qubits=n)


def layer_adjoint(us: torch.Tensor, sigma: torch.Tensor, m_in: int,
                  m_out: int) -> torch.Tensor:
    """Adjoint channel F^l: sigma^l -> sigma^{l-1},
    F(Y) = (I ⊗ <0..0|) U^H (I ⊗ Y) U (I ⊗ |0..0>)."""
    d_in, d_out = ql.dim(m_in), ql.dim(m_out)
    eye_in = torch.eye(d_in, dtype=sigma.dtype, device=sigma.device)
    full = torch.einsum("ab,...cd->...acbd", eye_in, sigma)
    full = full.reshape(sigma.shape[:-2] + (d_in * d_out, d_in * d_out))
    embedded = embedded_perceptrons(us, m_in, m_out)
    # U = U_m ... U_1  =>  U^H X U = U_1^H ... U_m^H X U_m ... U_1
    for j in range(m_out - 1, -1, -1):
        full = ql.apply_unitary(full, ql.dagger(_u(embedded, j)))
    t = full.reshape(sigma.shape[:-2] + (d_in, d_out, d_in, d_out))
    return t[..., :, 0, :, 0]


def feedforward(params: Params, rho_in: torch.Tensor, widths: Sequence[int]
                ) -> List[torch.Tensor]:
    rhos = [rho_in]
    for l in range(1, len(widths)):
        rhos.append(layer_forward(params[l - 1], rhos[-1],
                                  widths[l - 1], widths[l]))
    return rhos


def backward(params: Params, sigma_out: torch.Tensor, widths: Sequence[int]
             ) -> List[torch.Tensor]:
    sigmas = [sigma_out]
    for l in range(len(widths) - 1, 0, -1):
        sigmas.append(layer_adjoint(params[l - 1], sigmas[-1],
                                    widths[l - 1], widths[l]))
    return sigmas[::-1]


def oracle_deviation(ks: Params, params: Params, phi_in: torch.Tensor,
                     phi_out: torch.Tensor, widths: Sequence[int], eta,
                     weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Max-abs entrywise deviation of ``ks`` from the dense oracle's
    update matrices, over every layer and perceptron: a scalar, or (P,)
    per node with the node axis (the shape of the certificate it is held
    against)."""
    ks_ref = update_matrices(params, phi_in, phi_out, widths, eta,
                             weights=weights)
    single = params[0].dim() == 3
    dev = None
    for k, kr in zip(ks, ks_ref):
        d = (k - kr).abs()
        d = d.amax() if single else d.reshape(d.shape[0], -1).amax(-1)
        dev = d if dev is None else torch.maximum(dev, d)
    return dev


def update_matrices(params: Params, phi_in: torch.Tensor,
                    phi_out: torch.Tensor, widths: Sequence[int], eta,
                    weights: Optional[torch.Tensor] = None) -> Params:
    """Proposition 1 through the dense full-space sandwiches (seed path).

    weights: optional (X,) / (P, X) per-example weights, with the local
    engine's meaning (scale the label density, normalise by sum w), kept
    in float64 with the denominator max(sum w, 1e-12)."""
    single = params[0].dim() == 3
    if single:
        params = [p[None] for p in params]
        phi_in, phi_out = phi_in[None], phi_out[None]
        weights = None if weights is None else weights[None]
    rho_in = ql.pure_density(phi_in)
    sigma_l = ql.pure_density(phi_out)
    if weights is None:
        denom = phi_in.shape[-2]
    else:
        w = weights.to(ql.real_dtype(sigma_l.dtype))
        sigma_l = sigma_l * w[..., None, None].to(sigma_l.dtype)
        denom = torch.clamp(torch.sum(w, dim=-1), min=1e-12)[:, None, None]
    rhos = feedforward(params, rho_in, widths)
    sigmas = backward(params, sigma_l, widths)

    ks: Params = []
    for l in range(1, len(widths)):
        m_in, m_out = widths[l - 1], widths[l]
        n = m_in + m_out
        d_full = ql.dim(n)
        embedded = embedded_perceptrons(params[l - 1], m_in, m_out)
        p0 = ql.zero_projector(m_out, dtype=rho_in.dtype,
                               device=rho_in.device)
        a = torch.einsum("...ab,cd->...acbd", rhos[l - 1], p0)
        a = a.reshape(rhos[l - 1].shape[:-2] + (d_full, d_full))
        eye_in = torch.eye(ql.dim(m_in), dtype=rho_in.dtype,
                           device=rho_in.device)
        b = torch.einsum("ab,...cd->...acbd", eye_in, sigmas[l])
        b = b.reshape(sigmas[l].shape[:-2] + (d_full, d_full))
        bs = [b]
        for jj in range(m_out - 1, 0, -1):
            b = ql.apply_unitary(b, ql.dagger(_u(embedded, jj)))
            bs.append(b)
        bs = bs[::-1]

        layer_ks = []
        for j in range(m_out):
            a = ql.apply_unitary(a, _u(embedded, j))
            m = a @ bs[j] - bs[j] @ a
            keep = list(range(m_in)) + [m_in + j]
            m_traced = ql.partial_trace(m, keep=keep, n_qubits=n)
            layer_ks.append((eta * (2.0 ** m_in) * 1j / denom)
                            * torch.sum(m_traced, dim=1))
        ks.append(torch.stack(layer_ks, dim=1))
    return [k[0] for k in ks] if single else ks

"""Exponential-map 'optimizer' for unitary-parametrized models (the
QNN), the port of ``repro.optim.unitary``: U <- e^{i eps K} U with
Hermitian K, plus re-unitarization (QR with phase fixing) to keep long
runs on the manifold despite float error."""
from __future__ import annotations

from typing import List

import torch

from repro_torch.core.quantum import linalg as ql


def apply(params: List[torch.Tensor], ks: List[torch.Tensor], eps
          ) -> List[torch.Tensor]:
    return [ql.expm_herm(k, eps) @ us for us, k in zip(params, ks)]


def reunitarize(params: List[torch.Tensor]) -> List[torch.Tensor]:
    """Project each perceptron back onto the unitary manifold via QR,
    with the phases of R's diagonal moved into Q."""
    out = []
    for us in params:
        q, r = torch.linalg.qr(us)
        diag = torch.diagonal(r, dim1=-2, dim2=-1)
        out.append(q * (diag / diag.abs())[..., None, :])
    return out


def unitarity_error(params: List[torch.Tensor]) -> torch.Tensor:
    """max |U U^H - I| over every perceptron."""
    errs = []
    for us in params:
        eye = torch.eye(us.shape[-1], dtype=us.dtype, device=us.device)
        errs.append(torch.max(torch.abs(us @ ql.dagger(us) - eye)))
    return torch.max(torch.stack(errs))

"""Carry weights and data between the JAX reference and the port.

The reference's params are a list of complex arrays, one (m_l, d, d)
stack per layer; its ``QuantumDataset`` holds ``phi_in``, ``phi_out``
and an optional ``n_per``. These functions take and give numpy arrays
only (``np.asarray`` of a JAX array is one), so the port never touches
JAX.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.quantum import linalg as ql
from repro_torch.core.quantum.data import QuantumDataset


def _tensor(x, dtype, device) -> torch.Tensor:
    return torch.tensor(np.asarray(x), dtype=dtype,
                        device=ql.resolve_device(device))


def params_to_torch(params: Sequence[np.ndarray], device="cuda"
                    ) -> List[torch.Tensor]:
    """Per-layer (m_l, d, d) arrays -> complex128 tensors on ``device``."""
    return [_tensor(p, ql.DTYPE, device) for p in params]


def params_to_numpy(params: Sequence[torch.Tensor]) -> List[np.ndarray]:
    return [p.detach().resolve_conj().cpu().numpy() for p in params]


def states_to_torch(phi, device="cuda") -> torch.Tensor:
    """State vectors of any batch shape -> complex128 on ``device``."""
    return _tensor(phi, ql.DTYPE, device)


def dataset_to_torch(phi_in: np.ndarray, phi_out: np.ndarray,
                     n_per: Optional[np.ndarray] = None, device="cuda"
                     ) -> QuantumDataset:
    """A reference dataset's arrays -> the port's ``QuantumDataset``."""
    return QuantumDataset(
        states_to_torch(phi_in, device), states_to_torch(phi_out, device),
        None if n_per is None else _tensor(n_per, torch.int32, device))


def dataset_to_numpy(ds: QuantumDataset
                     ) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
    """The port's dataset -> (phi_in, phi_out, n_per) numpy arrays."""
    n_per = None if ds.n_per is None else ds.n_per.cpu().numpy()
    return ds.phi_in.cpu().numpy(), ds.phi_out.cpu().numpy(), n_per

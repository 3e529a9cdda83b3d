"""Carry weights, data and optimizer state between the JAX reference
and the port.

The reference's quantum params are a list of complex arrays, one
(m_l, d, d) stack per layer; its ``QuantumDataset`` holds ``phi_in``,
``phi_out`` and an optional ``n_per``. Its model params are a flat dict
of paths ("stack/{pos}/{kind}/..." with a leading n_cycles axis,
"rem/{i}/{kind}/..." without) to arrays. These functions take and give
numpy arrays only (``np.asarray`` of a JAX array is one), so the port
never touches JAX.

A stacked round's state carries a leading session axis S on every array
(params per layer (S, m_l, d, d), dataset fields (S, N, ...)); these
functions carry it as they carry any other axis. The server optimiser's
momentum is a per-layer list like params, or None before its first
step (``smom_to_torch``). An AdamW state is (step, m, v) with m and v
trees like the params (``adamw_state_to_torch``).
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.quantum import linalg as ql
from repro_torch.core.quantum.data import QuantumDataset
from repro_torch.models import Model
from repro_torch.optim import AdamWState
from repro_torch.optim.tree import tree_map


def _tensor(x, dtype, device) -> torch.Tensor:
    return torch.tensor(np.asarray(x), dtype=dtype,
                        device=ql.resolve_device(device))


def params_to_torch(params: Sequence[np.ndarray], device="cuda"
                    ) -> List[torch.Tensor]:
    """Per-layer (m_l, d, d) arrays (or (S, m_l, d, d) stacked) ->
    complex128 tensors on ``device``."""
    return [_tensor(p, ql.DTYPE, device) for p in params]


def params_to_numpy(params: Sequence[torch.Tensor]) -> List[np.ndarray]:
    return [p.detach().resolve_conj().cpu().numpy() for p in params]


def smom_to_torch(smom: Optional[Sequence[np.ndarray]], device="cuda"
                  ) -> Optional[List[torch.Tensor]]:
    """Server momentum, per layer (I_l, m_l, d, d) or stacked (S, I_l,
    m_l, d, d) -> complex128 tensors on ``device``; None stays None (the
    zero round-0 state)."""
    return None if smom is None else params_to_torch(smom, device)


def smom_to_numpy(smom: Optional[Sequence[torch.Tensor]]
                  ) -> Optional[List[np.ndarray]]:
    return None if smom is None else params_to_numpy(smom)


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


def _array_to_torch(x: np.ndarray) -> torch.Tensor:
    x = np.array(x)                  # a writable copy torch may own
    if x.dtype.name == "bfloat16":   # ml_dtypes' bfloat16: reinterpret bits
        return torch.from_numpy(x.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(x)


def model_params_to_torch(params: Mapping[str, np.ndarray], cfg,
                          device="cuda") -> Dict[str, torch.Tensor]:
    """The reference's flat model params -> the port's, name for name.

    Every path the port's ``init_model`` makes for ``cfg`` must be given
    once with the same shape, and no other path; each tensor is cast to
    ``cfg.param_dtype`` on ``device``."""
    dev = ql.resolve_device(device)
    want = Model(cfg).abstract_params()
    extra = sorted(set(params) - set(want))
    missing = sorted(set(want) - set(params))
    if extra or missing:
        raise KeyError(f"param paths differ: missing {missing}, "
                       f"unexpected {extra}")
    out = {}
    for path, spec in want.items():
        x = _array_to_torch(params[path])
        if tuple(x.shape) != tuple(spec.shape):
            raise ValueError(f"{path}: shape {tuple(x.shape)}, expected "
                             f"{tuple(spec.shape)}")
        out[path] = x.to(device=dev, dtype=spec.dtype)
    return out


def model_params_to_numpy(params: Mapping[str, torch.Tensor]
                          ) -> Dict[str, np.ndarray]:
    """The port's model params (or caches) -> numpy arrays, bfloat16 as
    float32 (numpy has no bfloat16 of its own)."""
    return {k: (v.float() if v.dtype == torch.bfloat16 else v)
            .detach().cpu().numpy() for k, v in params.items()}


def adamw_state_to_torch(state, device="cuda", dtype=None) -> AdamWState:
    """The reference's ``AdamWState`` (or any (step, m, v) with numpy
    leaves) -> the port's: step an int32 scalar on the CPU, m and v as
    ``dtype`` (default: each array's own; bfloat16 via its bits) on
    ``device``."""
    dev = ql.resolve_device(device)
    step, m, v = state

    def leaf(x):
        t = _array_to_torch(x)
        return t.to(device=dev, dtype=dtype or t.dtype)
    return AdamWState(step=torch.tensor(int(np.asarray(step)),
                                        dtype=torch.int32),
                      m=tree_map(leaf, m), v=tree_map(leaf, v))


def adamw_state_to_numpy(state: AdamWState):
    """The port's ``AdamWState`` -> (step int32 array, m, v) with numpy
    leaves, bfloat16 as float32."""
    def leaf(x):
        return (x.float() if x.dtype == torch.bfloat16 else x
                ).detach().cpu().numpy()
    return (np.asarray(int(state.step), np.int32), tree_map(leaf, state.m),
            tree_map(leaf, state.v))

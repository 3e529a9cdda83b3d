"""CUDA wrappers: per-pair fidelity Re<phi|rho|phi> and Frobenius MSE
||rho - |phi><phi|||_F^2 (source ``csrc/fidelity.cu``).

phi (N, d) and rho (N, d, d) complex128 on the card -> (N,) float64,
fp32 arithmetic inside. ``ops`` sends CPU tensors to ``ref`` instead.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.zgemm import check_operand, launch


def _run(fn_name: str, phi: torch.Tensor, rho: torch.Tensor
         ) -> torch.Tensor:
    check_operand(phi, "phi", 2)
    check_operand(rho, "rho", 3)
    n, d = phi.shape
    dev = phi.get_device()
    if rho.shape != (n, d, d) or rho.get_device() != dev:
        raise ValueError(f"{fn_name}: phi {tuple(phi.shape)}, rho "
                         f"{tuple(rho.shape)}")
    out = phi.new_empty((n,), dtype=torch.float64)
    launch(fn_name, "qf_" + fn_name, dev, phi.data_ptr(), rho.data_ptr(),
           out.data_ptr(), n, d)
    return out


def fidelity_batch(phi: torch.Tensor, rho: torch.Tensor) -> torch.Tensor:
    return _run("fidelity", phi, rho)


def mse_batch(phi: torch.Tensor, rho: torch.Tensor) -> torch.Tensor:
    return _run("mse", phi, rho)

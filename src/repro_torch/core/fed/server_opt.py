"""Server-side outer optimiser for the aggregated federation delta (the
port of ``repro.core.fed.server_opt``).

Instead of applying the data-volume-weighted aggregate directly (Alg. 2
/ FedAvg), the server runs (Nesterov) momentum on the averaged Hermitian
generators K̄_k of the Eq. 8 update unitaries, so the applied update
e^{i eps K_eff} stays exactly unitary. Only for ``combine == "average"``
strategies: the Eq. 6 product has no additive delta to smooth.

Registry: ``"none"`` (the paper's server), ``"momentum"``,
``"nesterov"``.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

from repro_torch.optim.sgd import SGD

SERVER_OPTS = ("none", "momentum", "nesterov")


def validate(name: str) -> str:
    if name not in SERVER_OPTS:
        raise ValueError(f"unknown server_opt {name!r}; registered: "
                         f"{list(SERVER_OPTS)}")
    return name


def make_sgd(name: str, beta: float) -> Optional[SGD]:
    """The ``optim/sgd.py`` optimizer a server_opt name denotes (for the
    classical substrate's fp32 delta trees); None for ``"none"``."""
    validate(name)
    if name == "none":
        return None
    return SGD(momentum=beta, nesterov=(name == "nesterov"))


def generator_step(name: str, beta, momentum: Any, kbar: Any
                   ) -> Tuple[Any, Any]:
    """One momentum step on an aggregated (complex Hermitian) generator:
    ``m' = beta m + K̄``; the applied generator is ``m'`` (momentum) or
    ``K̄ + beta m'`` (nesterov). ``momentum=None`` means round 0 (zero
    state). ``beta`` is a scalar or a tensor that broadcasts against
    ``kbar``. Returns ``(m', K_eff)``."""
    validate(name)
    if name == "none":
        return None, kbar
    m2 = kbar if momentum is None else beta * momentum + kbar
    eff = kbar + beta * m2 if name == "nesterov" else m2
    return m2, eff

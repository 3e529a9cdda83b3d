"""Federation registries of the port: aggregation strategies and
defenses, participation schedules, upload channels, the server
optimiser and fault injection; the classical ``FederatedConfig``; and
``api``, the federation front door (``FedSpec``, ``QuantumSubstrate``,
the schedulers and ``FederationSession``), which new programs should
start from."""
from repro_torch.core.fed import (  # noqa: F401
    channel, faults, participation, server_opt, strategies)
from repro_torch.core.fed.config import FederatedConfig  # noqa: F401
from repro_torch.core.fed import api  # noqa: E402,F401  (after the registries)

"""Federation registries of the port: aggregation strategies and
defenses, participation schedules, upload channels, the server
optimiser and fault injection; the classical substrate's round
(``FederatedConfig``, ``local`` steps and ``fed_step``: node deltas and
their weighted aggregation); and ``api``, the federation front door
(``FedSpec``, ``QuantumSubstrate`` / ``ClassicalSubstrate``, the
schedulers and ``FederationSession``), which new programs should start
from."""
from repro_torch.core.fed import (  # noqa: F401
    channel, faults, participation, server_opt, strategies)
from repro_torch.core.fed.config import FederatedConfig  # noqa: F401
from repro_torch.core.fed.fed_step import (  # noqa: F401
    fed_params_axes, fed_train_round, replicate_for_pods)
from repro_torch.core.fed.local import local_steps  # noqa: F401
from repro_torch.core.fed import api  # noqa: E402,F401  (after the registries)

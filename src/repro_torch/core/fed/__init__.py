"""Federation registries of the port: aggregation strategies and
defenses, participation schedules, upload channels, the server
optimiser and fault injection."""
from repro_torch.core.fed import (  # noqa: F401
    channel, faults, participation, server_opt, strategies)

"""Federation registries of the port: aggregation strategies,
participation schedules and upload channels."""
from repro_torch.core.fed import channel, participation, strategies  # noqa: F401

"""Multi-tenant federation serving (see the ``server`` module docstring;
the port of ``repro.core.fed.serve``).

``FederationServer`` drives thousands of concurrent
``FederationSession`` tenants on one card: same-fingerprint quantum
sessions run their rounds as ONE stacked ``server_round_stacked`` call
(``groups``), continuous-batching admission keeps a fixed grid of slots
full (``admission``), and an LRU checkpoint store parks cold sessions
to disk with bit-exact revival (``store``).
"""
from repro_torch.core.fed.serve.admission import SlotGrid
from repro_torch.core.fed.serve.groups import (SequentialGroup, StackedGroup,
                                               group_key, group_mode)
from repro_torch.core.fed.serve.server import FederationServer
from repro_torch.core.fed.serve.store import CheckpointStore

__all__ = [
    "FederationServer", "CheckpointStore", "SlotGrid", "StackedGroup",
    "SequentialGroup", "group_key", "group_mode",
]

"""The paper's own model: the 2-3-2 dissipative QNN trained by
QuantumFed (§IV-A), with the Fig. 2/3 hyperparameters. The port's own
copy of ``repro.configs.qnn_232``: ``CONFIG`` is the frozen Fig. 2/3
default, and the figure scripts build their variants through
``config(**overrides)``, which validates the strategy names against the
registries before any round runs. ``set_strategy_overrides`` installs
process-wide strategy defaults that ``config`` applies under its own
overrides."""
from repro_torch.core.fed import participation, strategies
from repro_torch.core.quantum.federated import QuantumFedConfig

WIDTHS = (2, 3, 2)

CONFIG = QuantumFedConfig(
    widths=WIDTHS,
    num_nodes=100,        # N
    nodes_per_round=10,   # N_p
    interval_length=1,    # I_l (Fig. 2 sweeps 1/2/4)
    eta=1.0,
    eps=0.1,
    aggregation="product",  # Eq. 6
)

N_PER_NODE = 4
N_TEST = 32
N_ITERATIONS = 50


# process-wide strategy defaults (a driver's --aggregation /
# --participation); explicit per-call overrides win
_OVERRIDES: dict = {}


def config(**overrides) -> QuantumFedConfig:
    """Fig. 2/3 defaults with registry-validated overrides."""
    cfg = CONFIG._replace(**{**_OVERRIDES, **overrides})
    strategies.get_aggregation(cfg.aggregation)
    participation.validate(cfg.participation)
    return cfg


def set_strategy_overrides(**kv) -> None:
    """Install process-wide strategy defaults (validated)."""
    probe = CONFIG._replace(**kv)
    strategies.get_aggregation(probe.aggregation)
    participation.validate(probe.participation)
    _OVERRIDES.update(kv)

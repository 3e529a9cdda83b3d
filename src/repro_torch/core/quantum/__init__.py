"""QuantumFed quantum core of the port: simulator + federated training."""
from repro_torch.core.quantum import data, federated, linalg, qnn  # noqa: F401
from repro_torch.core.quantum.federated import QuantumFedConfig  # noqa: F401

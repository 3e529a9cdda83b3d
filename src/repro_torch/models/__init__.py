"""Model substrate of the port (the classical path)."""
from repro_torch.models.model import Model  # noqa: F401

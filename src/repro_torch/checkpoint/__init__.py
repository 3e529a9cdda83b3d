"""npz checkpoints in the reference's format."""
from repro_torch.checkpoint.checkpoint import (  # noqa: F401
    restore, save, unflatten_like)

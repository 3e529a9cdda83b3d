"""Optimizers and schedules (the port of ``repro.optim``)."""
from repro_torch.optim.adamw import AdamW, AdamWState, global_norm  # noqa: F401
from repro_torch.optim.schedules import (  # noqa: F401
    constant, inverse_sqrt, linear_warmup_cosine)
from repro_torch.optim.sgd import SGD, SGDState  # noqa: F401

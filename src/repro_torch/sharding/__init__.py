from repro_torch.sharding.rules import (  # noqa: F401
    DEFAULT_RULES, constrain, num_params, sharding_for, spec_for)

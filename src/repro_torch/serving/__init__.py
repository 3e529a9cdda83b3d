from repro_torch.serving.scheduler import ContinuousBatcher, Request  # noqa: F401

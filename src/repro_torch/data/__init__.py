"""Synthetic data (the port of ``repro.data``; ``partition`` comes with
the classical federation, ROADMAP.md Queue 1 item 5(b))."""
from repro_torch.data.synthetic import BigramTask, token_batches  # noqa: F401

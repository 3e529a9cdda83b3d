"""Hand-written CUDA kernels for Hopper (sources in ``csrc/``), their
plain PyTorch versions (``ref``) and the device dispatch (``ops``)."""
from repro_torch.kernels import ops, ref  # noqa: F401

"""PyTorch + CUDA port of the QuantumFed reproduction, for one NVIDIA
H100. ``src/repro/`` (JAX) stays the reference the port is tested
against; this package imports neither JAX nor anything of ``repro``."""

"""QuantumFed core of the port: the quantum simulator and federation."""

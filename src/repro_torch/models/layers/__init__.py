"""Model layers of the port, one module per reference module."""

"""Plain PyTorch references of the steps the benchmark times (no JAX, no
code of the port)."""

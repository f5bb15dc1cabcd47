"""Plain PyTorch and NumPy references that decide ``correct``; they import
neither the port nor JAX."""

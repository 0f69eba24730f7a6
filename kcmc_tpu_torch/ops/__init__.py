"""Tensor operations and kernel wrappers of the PyTorch port (see the package docstring)."""

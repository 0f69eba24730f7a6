"""Host-side utilities of the PyTorch port (see the package docstring)."""

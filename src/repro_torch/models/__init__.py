"""Model assembly of the PyTorch port (dense family so far)."""

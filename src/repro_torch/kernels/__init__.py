"""Hand-written CUDA kernels of the PyTorch port (``csrc/``), each with its
plain PyTorch version beside it, and the torch oracles (``ref``)."""

"""Serving launch surface of the PyTorch port: the page allocator, the continuous-batching engine and the serve CLI."""

"""Benchmarks of the PyTorch port (counterparts of ``benchmarks/``). They
import ``torch`` and ``repro_torch``, never ``jax`` or ``repro``, and time
on the card with CUDA events."""

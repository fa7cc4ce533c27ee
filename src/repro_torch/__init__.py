"""repro_torch: the PyTorch and CUDA port of the AK primitive suite.

Laid out module for module like the JAX package ``repro`` (the
reference): ``repro_torch/core/sort.py`` is the counterpart of
``repro/core/sort.py``. It imports ``torch`` and ``numpy``, never ``jax``
and nothing of ``repro``. Its CUDA kernels (``kernels/csrc``) are built
with ``nvcc`` at first use into ``build/kernels``.
"""

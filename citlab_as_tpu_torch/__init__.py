"""citlab_as_tpu_torch — the article-separation pipeline in PyTorch for CUDA.

A port of ``citlab_as_tpu`` (JAX/flax on a TPU), module path for module
path, held against that package in ``tests/test_torch_*.py``. It imports
``torch`` and never ``jax``, ``flax`` or ``citlab_as_tpu``.

The TPU (Pallas) kernels become hand-written CUDA kernels for Hopper
(``csrc/*.cu``, built by ``ops/kernels/build.py``); each keeps a plain
PyTorch version beside it, which runs only for tensors on the CPU.
"""

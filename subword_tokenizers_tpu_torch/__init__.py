"""subword_tokenizers_tpu_torch — the PyTorch and CUDA port of
subword_tokenizers_tpu.

This slice holds FastWP batched encode: the end-to-end WordPiece scan and
the token-stream compaction run as hand-written CUDA kernels on an NVIDIA
GPU (``FastWP(device="cuda")``), or as their plain PyTorch versions on
the CPU (``FastWP(device="cpu")``). Outputs equal the JAX package's.
The package imports torch and never jax; it reads the JAX package's C++
sources and Unicode tables by file path and imports nothing from it.
"""

from .models.wordpiece import FastWP, NaiveWP  # noqa: F401

__version__ = "0.1.0"

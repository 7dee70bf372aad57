"""subword_tokenizers_tpu_torch — the PyTorch and CUDA port of
subword_tokenizers_tpu.

It holds FastWP batched encode (the end-to-end WordPiece scan and the
token-stream compaction), BPE training (``NaiveBPE``/``FastBPE``
``train``: pair counts, selection with hash unification, and merge with
compaction) and WordPiece training (``NaiveWP``/``FastWP`` ``train``:
the same kernels with selection by the exact score, and per-symbol
weights) and the batched encode of FastBPE, NaiveBPE and NaiveWP (the
per-word merge loop and the greedy longest match, each followed by the
compaction). On an NVIDIA GPU (``device="cuda"``) each runs as
hand-written CUDA kernels; on the CPU (``device="cpu"``) as their plain
PyTorch versions. Outputs equal the JAX package's.
The package imports torch and never jax; it reads the JAX package's C++
sources and Unicode tables by file path and imports nothing from it.
"""

from .models.bpe import FastBPE, NaiveBPE  # noqa: F401
from .models.wordpiece import FastWP, NaiveWP  # noqa: F401

__version__ = "0.1.0"

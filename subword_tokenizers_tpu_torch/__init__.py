"""subword_tokenizers_tpu_torch — the PyTorch and CUDA port of
subword_tokenizers_tpu.

It holds FastWP batched encode (the end-to-end WordPiece scan and the
token-stream compaction), BPE training (``NaiveBPE``/``FastBPE``
``train``: pair counts, selection with hash unification, and merge with
compaction) and WordPiece training (``NaiveWP``/``FastWP`` ``train``:
the same kernels with selection by the exact score, and per-symbol
weights) and the batched encode of FastBPE, NaiveBPE and NaiveWP (the
per-word merge loop and the greedy longest match, each followed by the
compaction), the data-parallel layer (``parallel/``), the benchmark
suite (``benchmarks/``), the CLI (``python3 -m
subword_tokenizers_tpu_torch.cli``), the dataset builder (``data/``)
and an H100 gather-latency probe (``tools/gather_probe.py``). On an
NVIDIA GPU (``device="cuda"``) each device step runs as hand-written
CUDA kernels; on the CPU (``device="cpu"``) as their plain PyTorch
versions. Outputs equal the JAX package's.
The package imports torch and never jax; it reads the JAX package's C++
sources and Unicode tables by file path and imports nothing from it.
"""

from .models.bpe import FastBPE, NaiveBPE  # noqa: F401
from .models.wordpiece import FastWP, NaiveWP  # noqa: F401
from .models.base import SubwordTokenizer  # noqa: F401
from .models.trie import E2ETrie, MatchTrie  # noqa: F401
from .utils import recover_sentence  # noqa: F401

# The reference's model names, in the JAX package's order.
TOKENIZERS = {
    "NaiveBPE": NaiveBPE,
    "NaiveWordPiece": NaiveWP,
    "FastBPE": FastBPE,
    "FastWordPiece": FastWP,
}

__version__ = "0.1.0"

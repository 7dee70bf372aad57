"""The PyTorch port's FastWP batched encode (``FastWP(device="cpu")``, the
kernels' plain PyTorch versions) against the JAX package's FastWP, on
``data/train-85k.json`` with the port fixture vocab
(``tests/golden/port_t85k_fastwp_vocab.json``, made by
``tools/gen_port_fixtures.py``), and on the routes and errors around it.
Exact equality of token lists and of error messages."""
import hashlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from subword_tokenizers_tpu import FastWP as JaxFastWP
from subword_tokenizers_tpu_torch import FastWP

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "golden")
N = 3000


def _digest(token_lists):
    return hashlib.sha256(json.dumps(token_lists, ensure_ascii=False)
                          .encode("utf-8")).hexdigest()


@pytest.fixture(scope="module")
def corpus():
    with open(os.path.join(ROOT, "data", "train-85k.json"),
              encoding="utf-8") as f:
        return json.load(f)[:N]


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """(JAX FastWP, port FastWP on the CPU), both loaded from one
    vocab.json through load_resources."""
    with open(os.path.join(GOLDEN, "port_t85k_fastwp_vocab.json"),
              encoding="utf-8") as f:
        vocab = json.load(f)
    d = tmp_path_factory.mktemp("vocab")
    with open(d / "vocab.json", "w", encoding="utf-8") as f:
        json.dump(vocab, f, ensure_ascii=False)
    jax_tok, port = JaxFastWP(), FastWP(device="cpu")
    jax_tok.load_resources(str(d), strict=True)
    port.load_resources(str(d), strict=True)
    return jax_tok, port


@pytest.fixture(scope="module")
def batches(pair, corpus):
    jax_tok, port = pair
    return jax_tok.tokenize_batch(corpus), port.tokenize_batch(corpus)


def _small(vocab):
    jax_tok, port = JaxFastWP(), FastWP(device="cpu")
    for tok in (jax_tok, port):
        tok.vocab = set(vocab)
        tok._build_e2e()
    return jax_tok, port


def _outcome(tok, batch):
    try:
        return "ok", tok.tokenize_batch(batch)
    except RuntimeError as e:
        return "err", str(e)


def _texts(seed, alphabet, n, max_len):
    rng = np.random.default_rng(seed)
    return ["".join(rng.choice(list(alphabet), size=rng.integers(0, max_len)))
            for _ in range(n)]


def test_batch_equals_jax_on_train85k(batches):
    want, got = batches
    assert got == want
    with open(os.path.join(GOLDEN, "port_t85k_fastwp_expect.json")) as f:
        expect = json.load(f)
    assert expect["small_n"] == N
    assert _digest(got) == expect["small_sha256"]


def test_host_tokenize_equals_jax(pair, corpus, batches):
    jax_tok, port = pair
    for i, s in enumerate(corpus[:50]):
        assert port.tokenize(s) == jax_tok.tokenize(s) == batches[1][i]


def test_tokenize_stream_equals_batch(pair, corpus, batches):
    _, port = pair
    assert list(port.tokenize_stream(iter(corpus),
                                     batch_sentences=1000)) == batches[1]
    with pytest.raises(ValueError):
        next(port.tokenize_stream(corpus, batch_sentences=0))


def test_empty_and_duplicate_sentences(pair, corpus):
    jax_tok, port = pair
    assert port.tokenize_batch([]) == jax_tok.tokenize_batch([]) == []
    batch = [corpus[0], corpus[0], "", "   ", corpus[1], corpus[0]]
    got = port.tokenize_batch(batch)
    assert got == jax_tok.tokenize_batch(batch)
    assert got[0] is not got[1]
    got[0].append("x")
    assert got[1] == got[5] != got[0]
    assert port.tokenize_batch(["", " \t "]) == [[], []]


def test_lower_special_route(pair, corpus):
    """U+0130 and U+03A3 need Python's own str.lower(): the fused front
    end declines and the chunk route runs, with sentence dedup."""
    jax_tok, port = pair
    batch = ["ΣΟΦΙΑ σας", corpus[2], "ΣΣ a-b", corpus[2], "x σ"]
    assert port._try_fused_chunked(batch) is None
    got = port.tokenize_batch(batch)
    assert got == jax_tok.tokenize_batch(batch)
    assert got[1] is not got[3]
    # "İ" lowers to "i" + U+0307, a punctuation-class char this vocab
    # lacks: both raise the same hang error.
    batch = [corpus[3], "x İ"]
    assert port._try_fused_chunked(batch) is None
    assert _outcome(port, batch) == _outcome(jax_tok, batch)
    assert _outcome(port, batch)[0] == "err"


def test_whitespace_vocab_route():
    """A whitespace-bearing token: whole sentences are scanned, on the
    general route."""
    jax_tok, port = _small({"a b", "a", "b", "##b", "!", "c"})
    assert port._trie()[0].has_ws_token
    for seed in range(3):
        batch = _texts(seed, "ab c!", 40, 12)
        assert _outcome(port, batch) == _outcome(jax_tok, batch)
    batch = ["a b!", "c a b !", "", "b c!"]
    assert _outcome(port, batch) == _outcome(jax_tok, batch)
    assert _outcome(port, batch)[0] == "ok"


def test_wide_pops_route():
    """Failure pops wider than 8 take the general route's output width
    and step cap."""
    jax_tok, port = _small({"a", "##a", "a" * 12 + "z", "!"})
    assert port._device_state().max_pops == 11
    rng = np.random.default_rng(4)
    words = ["a" * k for k in range(1, 16)] + ["a" * 12 + "z", "!", "a!"]
    batch = [" ".join(rng.choice(words, size=rng.integers(0, 8)))
             for _ in range(200)]
    assert _outcome(port, batch) == _outcome(jax_tok, batch)
    assert _outcome(port, batch)[0] == "ok"
    batch = _texts(4, "aaaaz! ", 100, 40)
    assert _outcome(port, batch) == _outcome(jax_tok, batch)


@pytest.mark.parametrize("vocab,batch,prefix", [
    ({"a"}, ["a", "a ¤", "¤ a"], "end-to-end scan makes no progress"),
    ({"a ", "a", "b"}, ["b", "b a"], "word-boundary check at end of input"),
    ({"#", "s", "a"}, ["s", "a ## s"], "encode_word('##') does not"),
])
def test_error_parity(vocab, batch, prefix):
    """The hang, crash and '##' cases raise the JAX package's errors, in
    the batch and in the host tokenize."""
    jax_tok, port = _small(vocab)
    got, want = _outcome(port, batch), _outcome(jax_tok, batch)
    assert got == want
    assert got[0] == "err" and got[1].startswith(prefix)
    with pytest.raises(RuntimeError) as e_port:
        port.tokenize(batch[-1])
    with pytest.raises(RuntimeError) as e_jax:
        jax_tok.tokenize(batch[-1])
    assert str(e_port.value) == str(e_jax.value)


def test_port_imports_no_jax():
    code = (
        "import sys\n"
        "from subword_tokenizers_tpu_torch import FastWP\n"
        "tok = FastWP(device='cpu')\n"
        "tok.vocab = {'a', '##b', 'c'}\n"
        "tok.load_resources('/nonexistent-dir')\n"
        "assert tok.tokenize_batch(['ab c', 'x']) == "
        "[['a', '##b', 'c'], [\"['UNK']\"]]\n"
        "from subword_tokenizers_tpu_torch import FastBPE\n"
        "bpe = FastBPE(device='cpu')\n"
        "bpe.train(['aaa aab abab', 'ab ba'], 8)\n"
        "assert bpe.merges_list[0] == ('a', 'b'), bpe.merges_list\n"
        "from subword_tokenizers_tpu_torch import NaiveWP\n"
        "wp = NaiveWP(device='cpu')\n"
        "wp.train(['aaa aab abab', 'ab ba'], 8)\n"
        "assert wp._merge_log and 'a' in wp.vocab, wp._merge_log\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith("
        "('jax.', 'subword_tokenizers_tpu.')) or m == "
        "'subword_tokenizers_tpu']\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


def test_cuda_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        FastWP(device="cuda")
    with pytest.raises(ValueError):
        FastWP(device="meta")

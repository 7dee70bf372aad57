"""Two faults of the port, held against the JAX package on the CPU:
FastBPE's ``reset`` keeps ``_bpe_ranks`` (the host encoder goes on using
them, ``tokenize_batch`` ranks the empty merge list), and the four
classes take the JAX package's ``(tokenizer=None, mesh=None)`` with
``device`` by keyword, an injected HF-style pre-tokenizer routed through
``preprocessing`` and ``preprocessing_batch``."""
import inspect
import json
import os
import re

import pytest
import torch

from subword_tokenizers_tpu import FastBPE as JaxFastBPE
from subword_tokenizers_tpu import FastWP as JaxFastWP
from subword_tokenizers_tpu import NaiveBPE as JaxNaiveBPE
from subword_tokenizers_tpu import NaiveWP as JaxNaiveWP
from subword_tokenizers_tpu_torch import FastBPE, FastWP, NaiveBPE, NaiveWP
from subword_tokenizers_tpu_torch.parallel.mesh import DataMesh, \
    make_data_mesh

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PAIRS = {"NaiveBPE": (JaxNaiveBPE, NaiveBPE), "FastBPE": (JaxFastBPE, FastBPE),
         "NaiveWP": (JaxNaiveWP, NaiveWP), "FastWP": (JaxFastWP, FastWP)}


@pytest.fixture(scope="module")
def corpus():
    with open(os.path.join(ROOT, "data", "train-85k.json"),
              encoding="utf-8") as f:
        return json.load(f)


class _PreTokenizer:
    """Splits on whitespace only, punctuation kept in the words (the
    built-in front end splits it off)."""

    @staticmethod
    def pre_tokenize_str(text):
        return [(m.group(), (m.start(), m.end()))
                for m in re.finditer(r"\S+", text)]


class _Backend:
    pre_tokenizer = _PreTokenizer()


class StandIn:
    """An HF-style tokenizer as the reference uses one: only
    ``backend_tokenizer.pre_tokenizer.pre_tokenize_str``."""

    backend_tokenizer = _Backend()


def _trained_fastbpe(cls, corpus, **kw):
    tok = cls(**kw)
    tok.train(corpus[:200], 150)
    return tok


def test_fastbpe_reset_keeps_ranks_as_jax(corpus):
    jax_tok = _trained_fastbpe(JaxFastBPE, corpus)
    port = _trained_fastbpe(FastBPE, corpus, device="cpu")
    assert port.merges_list == jax_tok.merges_list
    for tok in (jax_tok, port):
        tok.reset()
        assert tok.merges_list == [] and tok._bpe_ranks
    got = port.tokenize(corpus[3])
    assert got == jax_tok.tokenize(corpus[3])
    assert got[:5] == ["ba", "##r", "##dz", "##o", "się"]
    assert port.encode_word("niech") == jax_tok.encode_word("niech") \
        == ["nie", "##ch"]
    batch = corpus[:40]
    assert port.tokenize_batch(batch) == jax_tok.tokenize_batch(batch)
    # the batch ranks the empty merge list: every word stays unmerged
    assert port.tokenize_batch([corpus[3]])[0][:3] == ["b", "##a", "##r"]
    # loading resources gives the host encoder the loaded ranks again
    port.load_resources(os.path.join(ROOT, "missing"))
    assert port._bpe_ranks == {} and port.encode_word("niech") == \
        ["n", "##i", "##e", "##c", "##h"]


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_signature_is_jax(name):
    jax_cls, cls = PAIRS[name]
    params = inspect.signature(cls).parameters
    jax_params = inspect.signature(jax_cls).parameters
    assert list(params)[:2] == list(jax_params) == ["tokenizer", "mesh"]
    assert params["device"].kind is inspect.Parameter.KEYWORD_ONLY
    assert params["device"].default == "cuda"
    tok = cls(None, device="cpu")
    assert tok.tokenizer is None and tok.mesh is None
    assert tok.device == torch.device("cpu")
    if not torch.cuda.is_available():
        # None is the tokenizer: the default device is what refuses
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cls(None)
    else:
        assert cls(None).device.type == "cuda"


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_mesh_argument(name):
    _, cls = PAIRS[name]
    mesh = make_data_mesh(4, devices=["cpu"] * 8)
    assert mesh.size == 4 and mesh.type == "cpu"
    tok = cls(mesh=mesh, device="cpu")
    assert tok.mesh is mesh and tok.device == torch.device("cpu")
    # a mesh of another device type than the tokenizer's is refused
    with pytest.raises(ValueError, match="mesh is on cuda"):
        cls(mesh=DataMesh(["cuda:0"]), device="cpu")


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_injected_pretokenizer_as_jax(name, corpus):
    jax_cls, cls = PAIRS[name]
    sub = corpus[:120]
    jax_tok = jax_cls(StandIn())
    port = cls(StandIn(), device="cpu")
    builtin = cls(device="cpu")
    assert port.preprocessing(sub[:5]) == jax_tok.preprocessing(sub[:5])
    wb, jwb = port.preprocessing_batch(sub), jax_tok.preprocessing_batch(sub)
    for field in ("cps", "word_start", "word_end", "sent_id", "sent_cp_off"):
        assert (getattr(wb, field) == getattr(jwb, field)).all(), field
    vocab = 200 if "BPE" in name else 260
    for tok in (jax_tok, port, builtin):
        tok.train(sub, vocab)
    assert port.vocab == jax_tok.vocab
    assert port.corpus_as_symbols == jax_tok.corpus_as_symbols
    # the stand-in keeps punctuation in the words: another result
    assert port.corpus_as_symbols != builtin.corpus_as_symbols
    if "BPE" in name:
        assert port.merges_list == jax_tok.merges_list
    else:
        assert port._merge_log == jax_tok._merge_log
    text = sub[:30]
    assert [port.tokenize(s) for s in text] == \
        [jax_tok.tokenize(s) for s in text]
    assert port.tokenize_batch(text) == jax_tok.tokenize_batch(text)

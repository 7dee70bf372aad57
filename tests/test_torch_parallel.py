"""Sharded training and encode of the port on a mesh of CPU shards
(parallel/), on the kernels' plain versions: the cases of the JAX
package's ``tests/test_parallel.py`` on slices of ``data/train-85k.json``.
Sharded = single-device = the JAX package. Each test of a fallback tier
asserts which tier ran, and every step of every sharded run here checks
that its tier's winner equals the exact (full-tier) winner."""
import json
import os

import numpy as np
import pytest
import torch

from subword_tokenizers_tpu import FastBPE as JaxFastBPE
from subword_tokenizers_tpu import FastWP as JaxFastWP
from subword_tokenizers_tpu import NaiveBPE as JaxNaiveBPE
from subword_tokenizers_tpu import NaiveWP as JaxNaiveWP
from subword_tokenizers_tpu.parallel.mesh import make_data_mesh as jax_mesh
from subword_tokenizers_tpu_torch import FastBPE, FastWP, NaiveBPE, NaiveWP
from subword_tokenizers_tpu_torch.parallel import train as ptrain
from subword_tokenizers_tpu_torch.parallel.mesh import make_data_mesh

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "golden")
CLASSES = {NaiveBPE: JaxNaiveBPE, FastBPE: JaxFastBPE, NaiveWP: JaxNaiveWP}


@pytest.fixture(scope="module")
def corpus():
    with open(os.path.join(ROOT, "data", "train-85k.json"),
              encoding="utf-8") as f:
        return json.load(f)


@pytest.fixture(scope="module")
def mesh8():
    return make_data_mesh(8, devices=["cpu"] * 8)


@pytest.fixture(autouse=True)
def exact_every_step(monkeypatch):
    """Every step's tier answer against the full tier on the same state
    (the exact winner); counts the steps checked."""
    real = ptrain.ShardedTrainer.select
    checked = [0]

    def select(self):
        got = real(self)
        rec = torch.zeros(6, dtype=torch.int32)
        sym_freq = None if self.sym_cap is None else \
            ptrain.sharded_sym_freq(self.corpus, self.sym_cap)
        ptrain.sharded_select_full(self.corpus, rec, sym_freq)
        a, b, _, _, active, _ = rec.tolist()
        assert got == ((a, b) if active else None)
        checked[0] += 1
        return got

    monkeypatch.setattr(ptrain.ShardedTrainer, "select", select)
    return checked


def merges(tok):
    return tok.merges_list if hasattr(tok, "merges_list") else tok._merge_log


def train3(cls, text, vocab, mesh, **attrs):
    """(sharded port, single-device port, JAX) trained on ``text``."""
    out = []
    for tok in (cls(mesh=mesh, device="cpu"), cls(device="cpu"),
                CLASSES[cls]()):
        for k, v in attrs.items():
            setattr(tok, k, v)
        tok.train(text, vocab)
        out.append(tok)
    return out


def assert_same(toks):
    first = toks[0]
    for tok in toks[1:]:
        assert merges(tok) == merges(first)
        assert tok.vocab == first.vocab
        assert tok.corpus_as_symbols == first.corpus_as_symbols


@pytest.mark.parametrize("cls,vocab", [(NaiveBPE, 160), (NaiveWP, 180)])
def test_sharded_equals_single_and_jax(cls, vocab, corpus, mesh8,
                                       exact_every_step):
    toks = train3(cls, corpus[:60], vocab, mesh8)
    assert_same(toks)
    n = len(merges(toks[0]))
    assert exact_every_step[0] in (n, n + 1)


def test_fastbpe_uneven_rows(corpus, mesh8):
    text = corpus[:3]
    sharded, single, jax_tok = train3(FastBPE, text, 80, mesh8)
    assert_same((sharded, single, jax_tok))
    assert len(sharded.corpus_as_symbols) % 8 != 0
    for s in text:
        assert sharded.tokenize(s) == jax_tok.tokenize(s)
    assert sharded.tokenize_batch(text) == jax_tok.tokenize_batch(text)


@pytest.mark.parametrize("n", [1, 2, 4])
def test_mesh_sizes(n, corpus):
    toks = train3(NaiveBPE, corpus[:20], 100,
                  make_data_mesh(n, devices=["cpu"] * n))
    assert_same(toks)


@pytest.mark.parametrize("cls,vocab", [(NaiveBPE, 600), (NaiveWP, 700)])
def test_sharded_scale_topk(cls, vocab, corpus, mesh8):
    """Train-85k[:300] on 8 shards, against the JAX package's sharded
    run: the same merges and the same tiers (below 16,384 pair slots a
    shard the JAX package scores every run, as the port does, so even
    WordPiece's certificates agree); most steps settle at the
    bandwidth-lean tiers and the full position gather never fires."""
    sharded = cls(mesh=mesh8, device="cpu")
    sharded.train(corpus[:300], vocab)
    jax_tok = CLASSES[cls](mesh=jax_mesh(8))
    jax_tok.train(corpus[:300], vocab)
    assert_same((sharded, jax_tok))
    assert len(merges(sharded)) > 400
    stats = sharded._sel_stats
    assert stats == jax_tok._sel_stats
    assert sharded._topk_fallbacks == jax_tok._topk_fallbacks
    assert stats["proven"] > 0 and stats["full"] == 0, stats
    n = len(merges(sharded))
    assert sum(stats.values()) in (n, n + 1)


def test_uniform_counts_fall_back(mesh8):
    """Every pair count 1: the threshold never proves the winner, and the
    compact tier settles every step."""
    text = ["zyx wvu tsr qpo nml kji hgf edc ba"]
    sharded = NaiveBPE(mesh=mesh8, device="cpu")
    sharded.train(text, 40)
    jax_tok = JaxNaiveBPE()
    jax_tok.train(text, 40)
    assert sharded.merges_list == jax_tok.merges_list
    assert sharded._topk_fallbacks > 0
    assert sharded._sel_stats["compact"] > 0, sharded._sel_stats
    assert sharded._sel_stats["full"] == 0, sharded._sel_stats


def test_wp_tie_margin_falls_back(mesh8):
    """More than TOPK distinct pairs per shard, every score exactly 1.0:
    the winner goes by position, and the certificate's margin must refuse
    (a pair left out could tie the winning double)."""
    n = 8 * (ptrain.TOPK + 8)
    text = [" ".join(chr(0x4E00 + 2 * i) + chr(0x4E00 + 2 * i + 1)
                     for i in range(n))]
    target = 2 * n + 1  # one merge
    sharded = NaiveWP(mesh=mesh8, device="cpu")
    sharded.train(text, target)
    jax_tok = JaxNaiveWP()
    jax_tok.train(text, target)
    assert sharded.vocab == jax_tok.vocab
    assert sharded._merge_log == jax_tok._merge_log
    assert sharded._topk_fallbacks > 0, sharded._sel_stats
    assert sharded._sel_stats["proven"] == 0, sharded._sel_stats
    assert sharded._sel_stats["compact"] > 0, sharded._sel_stats


@pytest.mark.parametrize("cls", [NaiveBPE, NaiveWP])
@pytest.mark.parametrize("tier", ["compact", "full"])
def test_forced_tiers(cls, tier, corpus, mesh8):
    forced, single, jax_tok = train3(cls, corpus[:40], 140, mesh8,
                                     _force_tier=tier)
    assert_same((forced, single, jax_tok))
    stats = forced._sel_stats
    assert stats["proven"] == 0 and stats[tier] > 0, stats
    if tier == "full":
        assert stats["compact"] == 0, stats
    with pytest.raises(ValueError, match="_force_tier"):
        bad = cls(mesh=mesh8, device="cpu")
        bad._force_tier = "topk"
        bad.train(corpus[:5], 60)


def test_topk_gathers_candidates_only(mesh8, monkeypatch):
    """The top-K tier moves candidate-sized tensors between shards (K·D
    keys and 3·D threshold entries), never corpus-sized ones."""
    rng = np.random.default_rng(0)
    n, L = 512, 12  # 5,632 pair slots a shard, far above K·D = 2,048
    sym = rng.integers(0, 50, size=(n, L)).astype(np.int32)
    corpus = ptrain.shard_corpus(mesh8, sym, np.ones(n, dtype=np.int64))
    sizes = []
    for name in ("gather", "sum", "amin"):
        real = getattr(mesh8, name)

        def spy(parts, real=real, **kw):
            out = real(parts, **kw)
            sizes.append(out.numel())
            return out

        monkeypatch.setattr(mesh8, name, spy)
    rec = torch.zeros(6, dtype=torch.int32)
    ptrain.sharded_select_topk(corpus, [s.pairs() for s in corpus.shards],
                               rec)
    assert max(sizes) == ptrain.TOPK * 8
    assert sorted(sizes) == [3 * 8] + [ptrain.TOPK * 8] * 3


def test_resume_under_mesh(corpus, mesh8, tmp_path):
    """A checkpoint at 60 merges, resumed under the mesh, ends where an
    uninterrupted run does."""
    text = corpus[:80]
    part = NaiveBPE(mesh=mesh8, device="cpu")
    part.train(text, 140, checkpoint_dir=str(tmp_path), checkpoint_every=30)
    whole = NaiveBPE(device="cpu")
    whole.train(text, 200)
    resumed = NaiveBPE(mesh=mesh8, device="cpu")
    resumed.train(text, 200, checkpoint_dir=str(tmp_path), resume=True)
    assert resumed.merges_list == whole.merges_list
    assert resumed.corpus_as_symbols == whole.corpus_as_symbols
    n = len(whole.merges_list) - len(part.merges_list)
    assert sum(resumed._sel_stats.values()) in (n, n + 1)


def test_fastwp_sharded_encode_equals_jax(corpus, mesh8, tmp_path):
    """FastWP's scan over 8 shards (length-sorted blocks, the order
    restored) on 3,000 sentences equals the JAX package's
    ``FastWP(mesh=mesh8)``, and its digest."""
    import hashlib
    with open(os.path.join(GOLDEN, "port_t85k_fastwp_vocab.json"),
              encoding="utf-8") as f:
        vocab = json.load(f)
    with open(os.path.join(GOLDEN, "port_t85k_fastwp_expect.json"),
              encoding="utf-8") as f:
        expect = json.load(f)
    with open(tmp_path / "vocab.json", "w", encoding="utf-8") as f:
        json.dump(vocab, f, ensure_ascii=False)
    text = corpus[:expect["small_n"]]
    port = FastWP(mesh=mesh8, device="cpu")
    port.load_resources(str(tmp_path))
    jax_tok = JaxFastWP(mesh=jax_mesh(8))
    jax_tok.load_resources(str(tmp_path))
    got = port.tokenize_batch(text)
    assert got == jax_tok.tokenize_batch(text)
    assert hashlib.sha256(json.dumps(got, ensure_ascii=False).encode(
        "utf-8")).hexdigest() == expect["small_sha256"]
    assert [port.tokenize(s) for s in text[:50]] == got[:50]


def test_word_encoders_under_mesh(corpus, mesh8):
    """FastBPE, NaiveBPE and NaiveWP keep their kernels' route under a
    mesh: the same output as without one."""
    text = corpus[:400]
    for cls in (FastBPE, NaiveBPE, NaiveWP):
        sharded = cls(mesh=mesh8, device="cpu")
        sharded.train(text, 200)
        single = cls(device="cpu")
        single.train(text, 200)
        assert sharded.tokenize_batch(text) == single.tokenize_batch(text)


def test_parallel_modules_import_no_jax():
    import subprocess
    import sys
    code = (
        "import sys\n"
        "from subword_tokenizers_tpu_torch import NaiveBPE, FastWP\n"
        "from subword_tokenizers_tpu_torch.parallel import distributed, "
        "encode, mesh, train\n"
        "from subword_tokenizers_tpu_torch.ops import shard_select\n"
        "m = mesh.make_data_mesh(4, devices=['cpu'] * 4)\n"
        "t = NaiveBPE(mesh=m, device='cpu')\n"
        "t.train(['aab abab aab ba'], 8)\n"
        "w = FastWP(mesh=m, device='cpu')\n"
        "w.train(['aab abab aab ba'], 12)\n"
        "assert w.tokenize_batch(['abab']) == [w.tokenize('abab')]\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith("
        "('jax.', 'subword_tokenizers_tpu.')) or m == "
        "'subword_tokenizers_tpu']\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr

"""The encode cell: its plain encoder against the port's FastWP goldens,
its vocabulary against the plain trainer, and a run's ``correct`` with
the timed path broken underneath (each run skips the harness's look for
a card and drives the rest of a run on the port's plain versions,
``device="cpu"``, on a small corpus cut into the cell's batches of
1,000): a sound run comes out correct; one token dropped from one
sentence of one call, one batch's output given for another's, half of a
batch left out, and the control (the port loaded with one vocabulary
entry left out) each come out not correct. (One card: no exchange
between chips to leave out.)"""
import hashlib
import json
import os
import time

import pytest

from conftest import ENCODE_CELL as CELL, ROOT, encode_files, golden, \
    need_card
from portbench import harness
from portbench.reference import fastwp, pretok, trainer


def test_plain_encoder_reproduces_the_fastwp_goldens(source):
    """The 8,043-entry vocabulary's tokens of the first 3,000 sentences
    and of all 85,000, as the port's tests hold the port to them."""
    expect = golden("port_t85k_fastwp_expect.json")
    vocab = golden("port_t85k_fastwp_vocab.json")
    assert len(vocab) == expect["vocab_size"] == 8043
    enc = fastwp.FastWordPiece(vocab)
    got = enc.tokenize_batch(source)
    assert fastwp.digest(got[:expect["small_n"]]) == expect["small_sha256"]
    assert fastwp.digest(got) == expect["full_sha256"]
    assert sum(map(len, got)) == expect["full_tokens"] == 4_540_628
    assert fastwp.scan_rows(enc, source)["rows"] == expect["unique_chunks"]


def test_plain_encoder_rules():
    enc = fastwp.FastWordPiece(["a", "b", "ab", "##b", "##c", ",", "x"])
    # the longest match, "##" continuations, punctuation split off
    assert enc.tokenize("AB abc  b,x") == ["ab", "ab", "##c", "b", ",", "x"]
    # a segment that fails to end at a root: the literal
    assert enc.tokenize("ad") == [fastwp.UNK]
    # a whole sentence equals its chunks scanned alone
    text = "ab, abbc x  a,b"
    assert enc.walk(text.lower() + " ")[0] == enc.tokenize(text)
    # a punctuation character absent from the trie: the upstream hangs
    with pytest.raises(RuntimeError, match="no progress"):
        enc.tokenize("a ; b")


def test_vocabulary_is_what_the_plain_trainer_learns(source):
    """The cell's vocabulary file: the 20,000 entries the plain trainer
    learns from the whole source, every sentence once, as a sorted JSON
    list, with the digest the configuration freezes."""
    config = encode_files()[3]
    path = os.path.join(ROOT, config["vocab"], "vocab.json")
    with open(path, "rb") as f:
        raw = f.read()
    assert hashlib.sha256(raw).hexdigest() == config["vocab_sha256"]
    got = trainer.train(pretok.count_words(source), 20000, wordpiece=True)
    assert json.loads(raw) == sorted(got.vocab)
    assert len(got.vocab) == 20000


def run(seconds=0.01, seed=2 ** 31 + 77):
    return harness.run(CELL, seed, seconds, False, time.perf_counter(),
                       device="cpu", files=encode_files(3000),
                       check_chip=False)


def test_sound_run_is_correct():
    res = run(seconds=1.0)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 2
    assert res["checks"] == {"calls_wrong": {
        "value": 0, "limit": 0, "of": res["attempted"]}}
    assert set(res["metrics"]) == {"encode_mbps", "setup_s"}
    assert list(res)[-1] == "checks"


def test_traced_run_reads_the_fused_route():
    res = harness.run(CELL, 5, 0.01, True, time.perf_counter(), device="cpu",
                      files=encode_files(2000), check_chip=False)
    assert res["correct"] and res["attempted"] == 2
    # the plain versions launch no kernel: no roofline, idle throughout
    assert set(res["metrics"]) == {"enc_frontend_ms", "enc_device_ms",
                                   "enc_stitch_ms", "device_idle.encode"}
    assert all(res["metrics"][m]["value"] > 0 for m in res["metrics"])


def test_another_route_gives_no_result(monkeypatch):
    """A phase-timed batch on the sentence route (as a vocabulary with
    whitespace in an entry takes) leaves the run without a result."""
    from subword_tokenizers_tpu_torch.models import wordpiece
    monkeypatch.setattr(wordpiece.FastWP, "_tokenize_batch_chunked",
                        wordpiece.FastWP._tokenize_batch_sentences)
    with pytest.raises(harness.RunError, match="fused native"):
        harness.run(CELL, 5, 0.01, True, time.perf_counter(), device="cpu",
                    files=encode_files(1000), check_chip=False)


def calls_counted(fn):
    """``fn`` wrapped to receive its call's number (from 1) first."""
    seen = [0]

    def wrapped(*a, **kw):
        seen[0] += 1
        return fn(seen[0], *a, **kw)
    return wrapped


def test_a_token_dropped_where_it_is_produced(monkeypatch):
    """The stitch of the 5th call (the 2nd of the window, after three
    warm-up batches) drops one sentence's last token."""
    from subword_tokenizers_tpu_torch._native import binding
    stitch = binding.stitch_flat

    @calls_counted
    def dropped(n, *a, **kw):
        out = stitch(*a, **kw)
        if n == 5:
            out[7] = out[7][:-1]
        return out
    monkeypatch.setattr(binding, "stitch_flat", dropped)
    res = run(seconds=1.0)
    assert not res["correct"] and res["failed"] == 1


def test_one_batchs_output_for_anothers(monkeypatch):
    """The 5th call returns the 4th's output: a state left unchanged."""
    from subword_tokenizers_tpu_torch.models import wordpiece
    encode = wordpiece.FastWP.tokenize_batch
    last = []

    @calls_counted
    def stale(n, self, corpus):
        out = last[-1] if n == 5 else encode(self, corpus)
        last.append(out)
        return out
    monkeypatch.setattr(wordpiece.FastWP, "tokenize_batch", stale)
    res = run(seconds=1.0)
    assert not res["correct"] and res["failed"] == 1


def test_half_of_every_batch_left_out(monkeypatch):
    from subword_tokenizers_tpu_torch.models import wordpiece
    encode = wordpiece.FastWP.tokenize_batch

    def half(self, corpus):
        return encode(self, corpus[: len(corpus) // 2])
    monkeypatch.setattr(wordpiece.FastWP, "tokenize_batch", half)
    res = run()
    assert not res["correct"] and res["failed"] == res["attempted"]


def test_the_control_is_not_correct(monkeypatch):
    """The port loaded without the longest entry that starts a word
    (``zachodnioeuropejskiego``, in 15 source sentences), on a corpus that
    holds one of them: the calls of that batch differ, and only those."""
    mod = harness.task_module(encode_files()[3])
    init = mod.Task.__init__
    dropped = []

    def controlled(self, *a, **kw):
        init(self, *a, **kw)
        mod.control(self)
        dropped.append(sorted(set(self.vocab) - set(self.tok.vocab)))
    monkeypatch.setattr(mod.Task, "__init__", controlled)
    seed = 14  # its draw of 3,000 holds one such sentence, in batch 2
    res = run(seconds=2.0, seed=seed)
    assert dropped == [["zachodnioeuropejskiego"]]
    assert not res["correct"]
    assert 1 <= res["failed"] < res["attempted"]


@pytest.mark.chip
def test_encode_cell_on_the_card_takes_the_fused_route():
    """The encode cell on the card, its entries planted (it is not in
    BENCHMARK.json: PERF.md, section 7): a traced batch holds one fused
    scan and no other kernel; a traced run and a short window come out
    correct, the traced run reading the fused route's spans."""
    need_card()
    from portbench import corpus, devtrace
    files = encode_files()
    config, mix = files[3], files[4]
    task = harness.task_module(config).Task(
        config, corpus.draw(mix, 2 ** 31 + 40), mix, "cuda")
    task.warm()
    _, trace = devtrace.trace_call(task.once)
    assert [(n, c) for n, (c, _) in trace.kernels.items()] == [
        (n, 1) for n in trace.kernels if "scan_compact_kernel" in n]
    assert len(trace.kernels) == 1
    del task
    traced = harness.run(CELL, 2 ** 31 + 41, 3, True, time.perf_counter(),
                         files=files)
    assert traced["correct"], traced["checks"]
    assert set(traced["metrics"]) == {
        "enc_frontend_ms", "enc_device_ms", "enc_stitch_ms",
        "enc_scan_roofline", "device_idle.encode"}
    assert 0 < traced["metrics"]["enc_scan_roofline"]["value"] < 100
    window = harness.run(CELL, 2 ** 31 + 42, 3, False, time.perf_counter(),
                         files=files)
    assert window["correct"] and window["attempted"] > 100
    assert window["metrics"]["encode_mbps"]["value"] > 0

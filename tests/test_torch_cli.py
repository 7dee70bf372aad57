"""The port's CLI (``subword_tokenizers_tpu_torch.cli``, run with
``device="cpu"``) against the JAX package's, command for command, each
in its own working directory: the saved resources are equal byte for
byte, the ``.tokens.json`` files are equal, and stdout is equal once the
numbers on the timing lines are masked. Also the flag errors, and
``--train`` with no tqdm installed."""
import contextlib
import io
import json
import os
import re
import sys

import pytest
import torch

from subword_tokenizers_tpu import cli as jax_cli
from subword_tokenizers_tpu_torch import cli as port_cli

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODELS = ["NaiveBPE", "FastBPE", "NaiveWordPiece", "FastWordPiece"]
TINY = ["aaa aab abab banana bandana!", "ab ab ab cd cd"]
TIMED = ("Training time", "Total time", "Throughput", "Avg. latency",
         "Batch latency")
FILES = {"NaiveBPE": "merges.json", "FastBPE": "merges.json",
         "NaiveWordPiece": "vocab.json", "FastWordPiece": "vocab.json"}


def _corpus(name):
    if name == "tiny":
        return TINY, 30
    with open(os.path.join(ROOT, "data", "train-85k.json"),
              encoding="utf-8") as f:
        return json.load(f)[:200], 300


def _steps(vocab):
    """(name, argv) of the commands run in each working directory."""
    v = str(vocab)
    return [
        ("train", ["--model", *MODELS, "--train", "train.json",
                   "--max_vocab", v, "--save", "vd"]),
        ("tokenize_file", ["--model", *MODELS, "--pretrained", "vd",
                           "--tokenize", "train.json"]),
        ("tokenize_str", ["--model", *MODELS, "--pretrained", "vd",
                          "--tokenize", "Litwo! Ojczyzno moja!"]),
        ("benchmark", ["--model", *MODELS, "--pretrained", "vd",
                       "--benchmark", "train.json"]),
        ("compare", ["--model", *MODELS, "--pretrained", "vd",
                     "--benchmark", "train.json", "--compare"]),
        ("benchmark_train", ["--model", "NaiveBPE", "NaiveWordPiece",
                             "--benchmark", "train.json", "--max_vocab", v]),
        ("reset", ["--model", *MODELS, "--reset", "vd"]),
        ("reset_again", ["--model", "NaiveBPE", "--reset", "vd"]),
    ]


def _mask(out):
    lines = []
    for ln in out.splitlines():
        if ln.startswith(TIMED):
            ln = re.sub(r"\d+(\.\d+)?(e[-+]?\d+)?", "#", ln)
        lines.append(ln)
    return "\n".join(lines)


def _run_all(main, workdir, corpus, vocab, **kw):
    """Run every step in ``workdir``: ({step: stdout}, {model: resource
    bytes}, .tokens.json)."""
    os.makedirs(workdir)
    with open(os.path.join(workdir, "train.json"), "w",
              encoding="utf-8") as f:
        json.dump(corpus, f, ensure_ascii=False)
    outs, resources, tokens = {}, {}, None
    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        for step, argv in _steps(vocab):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                main(argv, **kw)
            outs[step] = buf.getvalue()
            if step == "train":
                for m in MODELS:
                    with open(os.path.join("resources", "vd", m, FILES[m]),
                              "rb") as f:
                        resources[m] = f.read()
            if step == "tokenize_file":
                with open("train.tokens.json", "rb") as f:
                    tokens = f.read()
        assert not os.path.isdir(os.path.join("resources", "vd", "NaiveBPE"))
    finally:
        os.chdir(cwd)
    return outs, resources, tokens


@pytest.fixture(scope="module", params=["tiny", "t85k_200"])
def runs(request, tmp_path_factory):
    corpus, vocab = _corpus(request.param)
    base = tmp_path_factory.mktemp(f"cli_{request.param}")
    jax_run = _run_all(jax_cli.main, str(base / "jax"), corpus, vocab)
    port_run = _run_all(port_cli.main, str(base / "port"), corpus, vocab,
                        device="cpu")
    return jax_run, port_run


@pytest.mark.parametrize("model", MODELS)
def test_resources_byte_equal(runs, model):
    (_, jax_res, _), (_, port_res, _) = runs
    assert port_res[model] == jax_res[model]
    assert len(json.loads(port_res[model])) > 0


def test_tokens_json_equal(runs):
    (_, _, jax_tokens), (_, _, port_tokens) = runs
    assert port_tokens == jax_tokens
    assert list(json.loads(port_tokens)) == MODELS


@pytest.mark.parametrize("step", [s for s, _ in _steps(0)])
def test_stdout_equal_masked(runs, step):
    (jax_out, _, _), (port_out, _, _) = runs
    assert _mask(port_out[step]) == _mask(jax_out[step])
    assert port_out[step]


def test_timing_lines_masked(runs):
    """The masked lines are the timing lines of the report, and only
    those differ."""
    (jax_out, _, _), (port_out, _, _) = runs
    timed = [ln for ln in port_out["benchmark"].splitlines()
             if ln.startswith(TIMED)]
    assert len(timed) == 4 * len(MODELS)
    assert any(ln.startswith("Training time")
               for ln in port_out["benchmark_train"].splitlines())


@pytest.mark.parametrize("argv", [
    ["--model", "NaiveBPE", "FastBPE", "--benchmark", "train.json",
     "--compare"],
    ["--model", "NaiveBPE", "--pretrained", "x", "--benchmark",
     "train.json", "--compare"],
    ["--model", "NaiveBPE", "--benchmark", "nope.txt"],
    ["--model", "NotAModel"],
    [],
])
def test_flag_errors_match(argv, tmp_path, monkeypatch, capsys):
    got = {}
    for name, main, kw in (("jax", jax_cli.main, {}),
                           ("port", port_cli.main, {"device": "cpu"})):
        d = tmp_path / name
        d.mkdir()
        (d / "train.json").write_text(json.dumps(TINY))
        monkeypatch.chdir(d)
        with pytest.raises(SystemExit) as e:
            main(argv, **kw)
        cap = capsys.readouterr()
        got[name] = (e.value.code, cap.out, cap.err)
    assert got["port"] == got["jax"]
    assert got["port"][0] == 2 and "error:" in got["port"][2]


def test_train_without_tqdm(tmp_path, monkeypatch, capsys):
    """``--train`` (progress on) runs with no tqdm importable, writes its
    count of merges to stderr, and saves what the JAX CLI saves."""
    argv = ["--model", "NaiveBPE", "FastWordPiece", "--train", "train.json",
            "--max_vocab", "30", "--save", "vd"]
    saved = {}
    for name, main, kw in (("jax", jax_cli.main, {}),
                           ("port", port_cli.main, {"device": "cpu"})):
        d = tmp_path / name
        d.mkdir()
        (d / "train.json").write_text(json.dumps(TINY))
        monkeypatch.chdir(d)
        if name == "port":
            monkeypatch.setitem(sys.modules, "tqdm", None)
        main(argv, **kw)
        saved[name] = [(d / "resources" / "vd" / m / FILES[m]).read_bytes()
                       for m in ("NaiveBPE", "FastWordPiece")]
    err = capsys.readouterr().err
    assert "Training BPE: " in err and "Training WordPiece: " in err
    assert saved["port"] == saved["jax"]


def test_build_parser_matches():
    """The flags, their defaults and choices equal the JAX parser's."""
    def surface(parser):
        return [(a.option_strings, a.dest, a.default, a.nargs,
                 tuple(a.choices) if a.choices else None, a.required)
                for a in parser._actions]

    assert surface(port_cli.build_parser()) == \
        surface(jax_cli.build_parser())

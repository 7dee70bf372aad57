"""The port's package surface against the JAX package's: ``TOKENIZERS``
and the other top-level exports, ``recover_sentence``, the dataset
builder, the progress writer, and the rule that no new module imports
jax or the JAX package."""
import os
import subprocess
import sys

import pytest

import subword_tokenizers_tpu as jax_pkg
import subword_tokenizers_tpu_torch as port
from subword_tokenizers_tpu.data.build import \
    build_dataset as jax_build_dataset
from subword_tokenizers_tpu.utils import \
    recover_sentence as jax_recover_sentence
from subword_tokenizers_tpu_torch import utils
from subword_tokenizers_tpu_torch.data.build import build_dataset

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SPLITS = {
    "train": [{"text": "a"}, {"other": 1}, {"text": None}, {"text": "b"}],
    "test": [{"text": "c"}],
    "validation": [{"text": "d"}, {"text": "e"}],
}


def test_tokenizers_names_and_order():
    assert list(port.TOKENIZERS) == list(jax_pkg.TOKENIZERS) == [
        "NaiveBPE", "NaiveWordPiece", "FastBPE", "FastWordPiece"]
    for name, cls in port.TOKENIZERS.items():
        assert cls.__name__ == jax_pkg.TOKENIZERS[name].__name__
        assert cls.__module__.startswith("subword_tokenizers_tpu_torch.")
        assert issubclass(cls, port.SubwordTokenizer)


@pytest.mark.parametrize("name", ["SubwordTokenizer", "E2ETrie",
                                  "MatchTrie", "recover_sentence",
                                  "NaiveBPE", "FastBPE", "NaiveWP",
                                  "FastWP", "TOKENIZERS", "__version__"])
def test_exports(name):
    assert hasattr(jax_pkg, name)
    got = getattr(port, name)
    if callable(got):
        assert got.__module__.startswith("subword_tokenizers_tpu_torch.")


@pytest.mark.parametrize("tokens", [
    [],
    ["hello"],
    ["li", "##two", "!", "oj", "##czy", "##zno", "mo", "##ja", "!"],
    ["(", "a", ")", "[", "b", "]", "c", ".", "d", ","],
    ["it", "'", "s", "a", "-", "b", "/", "c", "\\", "d"],
    ["’", "x", "##", "##y", "z", "’"],
    ["##a", "b", " ", "##", "c"],
    ["a", " ", "(", " ", ".", "'"],
])
def test_recover_sentence_equals_jax(tokens):
    assert port.recover_sentence(tokens) == jax_recover_sentence(tokens)


@pytest.mark.parametrize("cap", [None, 0, 1, 3, 4, 99])
def test_build_dataset_equals_jax(cap):
    got = build_dataset(SPLITS, "text", cap)
    assert got == jax_build_dataset(SPLITS, "text", cap)
    if cap is not None:
        assert len(got) == min(max(cap, 1), 5)


def test_build_dataset_empty():
    assert build_dataset({}, "text") == jax_build_dataset({}, "text") == []
    assert build_dataset({}, "text", 0) == jax_build_dataset({}, "text", 0)


def test_progress_writer(capsys):
    """The first update is written at once, later ones at most every
    ``EVERY`` seconds, and ``close`` writes the final count."""
    bar = utils.Progress(total=5, desc="Training BPE")
    for _ in range(3):
        bar.update(1)
    bar.update(2)
    bar.close()
    err = capsys.readouterr().err
    assert err.startswith("\rTraining BPE: 1/5")
    assert err.endswith("\rTraining BPE: 5/5\n") and bar.n == 5


def test_new_modules_import_no_jax():
    code = (
        "import sys\n"
        "import subword_tokenizers_tpu_torch as p\n"
        "from subword_tokenizers_tpu_torch import cli, utils\n"
        "from subword_tokenizers_tpu_torch.benchmarks import metrics, "
        "suite\n"
        "from subword_tokenizers_tpu_torch.data import build\n"
        "from subword_tokenizers_tpu_torch.tools import gather_probe\n"
        "assert list(p.TOKENIZERS) == ['NaiveBPE', 'NaiveWordPiece', "
        "'FastBPE', 'FastWordPiece']\n"
        "assert build.build_dataset({'a': [{'t': 'x'}]}, 't', 0) == ['x']\n"
        "assert p.recover_sentence(['a', '##b']) == 'ab'\n"
        "assert cli.build_parser().parse_args(['-m', 'FastBPE']).max_vocab "
        "== 1000\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith("
        "('jax.', 'subword_tokenizers_tpu.')) or m == "
        "'subword_tokenizers_tpu']\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]


def test_cli_module_entry_point_help():
    """``python3 -m subword_tokenizers_tpu_torch.cli --help`` runs with no
    card (the tokenizers are built only after the flags parse)."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run(
        [sys.executable, "-m", "subword_tokenizers_tpu_torch.cli", "--help"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "--max_vocab" in proc.stdout and "FastWordPiece" in proc.stdout


def test_cli_without_cuda_raises(tmp_path, monkeypatch):
    """Nothing catches a missing card: the default device is CUDA."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("this test needs a machine without CUDA")
    from subword_tokenizers_tpu_torch.cli import main
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--model", "FastBPE", "--tokenize", "a b"])

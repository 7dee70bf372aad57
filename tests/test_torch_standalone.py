"""The port stands alone: a copy of ``subword_tokenizers_tpu_torch/`` with
the goldens and the corpus, without the JAX package beside it, imports,
builds its native front end from its own ``_native/`` sources with g++
and encodes on the CPU exactly as the JAX package does; and the package
data ships every source and table the port reads."""
import fnmatch
import json
import os
import shutil
import subprocess
import sys
import tomllib

import pytest

from subword_tokenizers_tpu import FastWP as JaxFastWP
from subword_tokenizers_tpu import NaiveBPE as JaxNaiveBPE

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = "subword_tokenizers_tpu_torch"
N_SENTENCES = 200

# Run in the copy: the port's encodes of the first sentences, with the
# resources the goldens hold, and where its front end was loaded from.
CHILD = r"""
import importlib.util, json, os, sys, tempfile
root = os.getcwd()
sys.path[:] = [root] + [p for p in sys.path[1:]
                        if os.path.abspath(p or ".") != root]
assert importlib.util.find_spec("subword_tokenizers_tpu") is None
from subword_tokenizers_tpu_torch import FastWP, NaiveBPE
from subword_tokenizers_tpu_torch._native import binding

def load(tok, name, path):
    with open(os.path.join("tests", "golden", path), encoding="utf-8") as f:
        data = json.load(f)
    with tempfile.TemporaryDirectory() as d:
        with open(os.path.join(d, name), "w", encoding="utf-8") as f:
            json.dump(data, f, ensure_ascii=False)
        tok.load_resources(d, strict=True)
    return tok

with open(os.path.join("data", "train-85k.json"), encoding="utf-8") as f:
    text = json.load(f)[:int(sys.argv[1])]
out = {
    "FastWP": load(FastWP(device="cpu"), "vocab.json",
                   "port_t85k_fastwp_vocab.json").tokenize_batch(text),
    "NaiveBPE": load(NaiveBPE(device="cpu"), "merges.json",
                     "port_t85k_v8000_bpe_merges.json").tokenize_batch(text),
    "so": binding.load()._name,
    "spec": importlib.util.find_spec("subword_tokenizers_tpu_torch").origin,
}
json.dump(out, sys.stdout)
"""


def _load(tok, name, path, tmp):
    with open(os.path.join(ROOT, "tests", "golden", path),
              encoding="utf-8") as f:
        data = json.load(f)
    d = tmp / name.split(".")[0]
    d.mkdir()
    with open(d / name, "w", encoding="utf-8") as f:
        json.dump(data, f, ensure_ascii=False)
    tok.load_resources(str(d))
    return tok


def test_the_port_encodes_without_the_jax_package(tmp_path):
    """The copy's FastWP and NaiveBPE batched encodes of the corpus's
    first 200 sentences equal the JAX package's, with the vocab and
    merges of the goldens, and the front end it loads was built from the
    copy's own sources into the copy's ``_native/build/``."""
    copy = tmp_path / "copy"
    shutil.copytree(os.path.join(ROOT, PORT), copy / PORT,
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    shutil.copytree(os.path.join(ROOT, "tests", "golden"),
                    copy / "tests" / "golden")
    (copy / "data").mkdir()
    shutil.copy(os.path.join(ROOT, "data", "train-85k.json"), copy / "data")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", CHILD, str(N_SENTENCES)],
                          cwd=copy, env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    got = json.loads(proc.stdout)
    assert got["spec"] == str(copy / PORT / "__init__.py")
    assert os.path.dirname(got["so"]) == str(copy / PORT / "_native" /
                                             "build")
    with open(os.path.join(ROOT, "data", "train-85k.json"),
              encoding="utf-8") as f:
        text = json.load(f)[:N_SENTENCES]
    want = {
        "FastWP": _load(JaxFastWP(), "vocab.json",
                        "port_t85k_fastwp_vocab.json",
                        tmp_path).tokenize_batch(text),
        "NaiveBPE": _load(JaxNaiveBPE(), "merges.json",
                          "port_t85k_v8000_bpe_merges.json",
                          tmp_path).tokenize_batch(text),
    }
    for name, tokens in want.items():
        assert got[name] == [list(t) for t in tokens], name
        assert sum(map(len, tokens)) > 2000


@pytest.mark.parametrize("suffix", [".cpp", ".npz", ".cu", ".cuh"])
def test_package_data_ships_what_the_port_reads(suffix):
    """Every C++ and CUDA source and every table file of the port matches
    one of the port's package-data globs in ``pyproject.toml``, and the
    front end's sources, its tables and the kernels' headers are among
    what the port reads."""
    from subword_tokenizers_tpu_torch._native import binding
    from subword_tokenizers_tpu_torch.frontend import charclass
    from subword_tokenizers_tpu_torch.ops import _cuda
    with open(os.path.join(ROOT, "pyproject.toml"), "rb") as f:
        globs = tomllib.load(f)["tool"]["setuptools"]["package-data"][PORT]
    base = os.path.join(ROOT, PORT)
    found = []
    for d, dirs, files in os.walk(base):
        dirs[:] = [x for x in dirs if x not in ("build", "__pycache__")]
        found += [os.path.relpath(os.path.join(d, f), base) for f in files
                  if f.endswith(suffix)]
    assert found
    for rel in found:
        assert any(fnmatch.fnmatch(rel, g) for g in globs), rel
    read = {".cpp": binding._SRCS, ".npz": [charclass.TABLE_PATH],
            ".cu": _cuda._sources(), ".cuh": _cuda._headers()}[suffix]
    assert sorted(os.path.relpath(p, base) for p in read) == sorted(found)

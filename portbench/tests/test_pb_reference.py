"""The plain trainer against the port's 8k goldens, on the whole source
file as it is (the goldens are data here: this file copies no code of
the tests or of the port)."""
import ast
import glob
import os

from conftest import ROOT, golden
from portbench.reference import pretok, trainer


def test_bpe_reproduces_8k_golden(source_counts):
    got = trainer.train(source_counts, 8000, wordpiece=False)
    want = [tuple(p) for p in golden("port_t85k_v8000_bpe_merges.json")]
    assert len(want) == 7922
    assert got.merges == want
    assert len(got.vocab) == 8000


def test_wordpiece_reproduces_8k_golden(source_counts):
    got = trainer.train(source_counts, 8000, wordpiece=True)
    want = golden("port_t85k_v8000_wp_vocab.json")
    assert len(want["merges"]) == 7879 and len(want["vocab"]) == 8000
    assert got.merges == [tuple(p) for p in want["merges"]]
    assert sorted(got.vocab) == sorted(want["vocab"])


def test_source_word_types(source_counts):
    assert len(source_counts) == 22971
    assert len(set("".join(source_counts))) == 78


def test_pre_tokenizer():
    assert pretok.words_of("Ala ma  KOTA, a kot ma Alę! (rys. 5) € x²") \
        == ["ala", "ma", "kota", ",", "a", "kot", "ma", "alę", "!", "(",
            "rys", ".", "5", ")", "€", "x²"]
    # Python's lower-casing, then the split: U+0130 lowers to two
    # codepoints; U+2028 and U+3000 are White_Space; U+00B7 is punctuation
    assert pretok.words_of("İx y　z·w") == \
        ["i̇x", "y", "z", "·", "w"]
    assert pretok.count_words(["b a b", "c b"]) == {"b": 3, "a": 1, "c": 1}
    assert pretok.count_drawn(["b a b", "c b"], [1, 0, 1]) == \
        {"c": 2, "b": 4, "a": 1}


def test_ties_go_to_the_first_pair_in_scan_order():
    # ("c", "d") and ("y", "x") both count 2; ("c", "d") is met first,
    # ("y", "x") has the smaller symbol ids (x 0, y 1, c 2, d 3)
    counts = {"xy": 1, "cd": 2, "yx": 2}
    assert trainer.train(counts, 5, wordpiece=False).merges[0] == ("c", "d")
    assert trainer.train(counts, 5, wordpiece=False,
                         variant="pair_order").merges[0] == ("y", "x")


def test_wordpiece_scores_exactly():
    # ("x", "##y"): 3 / (3 * 3); ("a", "##b"): 2 / (2 * 2) is larger
    got = trainer.train({"xy": 3, "ab": 2}, 6, wordpiece=True)
    assert got.merges[0] == ("a", "##b")
    assert got.vocab >= {"ab", "xy", "a", "##b"}


def test_reference_imports_nothing_of_the_program():
    """The reference and the yardstick import neither JAX, the JAX
    package, nor the port."""
    banned = {"jax", "jaxlib", "flax", "subword_tokenizers_tpu",
              "subword_tokenizers_tpu_torch"}
    files = glob.glob(os.path.join(ROOT, "portbench", "reference", "*.py"))
    files += [os.path.join(ROOT, "portbench", n)
              for n in ("corpus.py", "roofline.py")]
    for path in files:
        with open(path, encoding="utf-8") as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and not node.level:
                names = [node.module]
            for n in names:
                assert n.split(".", 1)[0] not in banned, (path, n)

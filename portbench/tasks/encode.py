"""The ``encode`` task: one call of a tokenizer's public ``tokenize_batch``
on the next batch of the cell's corpus, and its check against the plain
encoder.

A configuration of this task names the port's tokenizer class
(``tokenizer``: ``FastWP``), its vocabulary (``vocab``: a directory,
from the checkout's root, that holds the ``vocab.json`` the tokenizer's
``load_resources`` reads) and that file's ``vocab_sha256``. Set-up loads
the vocabulary once, as users do, with ``load_resources(dir,
strict=True)`` (which builds the trie), then encodes every batch once,
so that every shape the window uses is warm. The mix's ``batch`` cuts
the drawn corpus into batches of that many sentences, in draw order;
calls go through them in turn, back to back.

What a call produces is one token list a sentence. What is kept of it
(outside the call's time) is the batch's index and the sha256 of its
token lists as JSON: the lists of thousands of calls, held as Python
objects, would take gigabytes, and Python's collector would walk them
inside later calls. Each kept digest is compared with that of the plain
encoder's lists for the same batch (``portbench/reference/fastwp.py``);
the number compared is how many calls differ, whose limit is 0.

A phase-timed call that did not take the fused native route
(``encode.native_prep``, ``encode.pack_u16``, ``encode.scan``: the route
users get on a vocabulary without whitespace and a corpus without
U+0130 or U+03A3) leaves the run without a result.

The control (:func:`control`): the port loaded with the vocabulary's
longest entry that starts a word left out. (Its longest entry of all is
a ``##`` continuation whose whole word is an entry too, so leaving it
out changes no token.)
"""
from __future__ import annotations

import hashlib
import json
import os
import tempfile
from typing import Dict, List, Optional, Tuple

from ..reference import fastwp

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
TOKENIZERS = ("FastWP",)
ROUTE = ("encode.native_prep", "encode.pack_u16", "encode.scan")


def load_vocab(config: dict) -> List[str]:
    """The configuration's vocabulary, after checking the file's
    digest."""
    path = os.path.join(ROOT, config["vocab"], "vocab.json")
    with open(path, "rb") as f:
        raw = f.read()
    digest = hashlib.sha256(raw).hexdigest()
    if digest != config["vocab_sha256"]:
        raise ValueError(f"{config['vocab']}/vocab.json: sha256 {digest}, "
                         f"the configuration wants {config['vocab_sha256']}")
    return json.loads(raw.decode("utf-8"))


class Task:
    """Calls of ``config``'s tokenizer over the batches of ``corpus``
    (portbench/corpus.py), ``mix["batch"]`` sentences each, on
    ``device``."""

    def __init__(self, config: dict, corpus, mix: dict, device: str
                 ) -> None:
        name = config["tokenizer"]
        if name not in TOKENIZERS:
            raise ValueError(f"tokenizer must be one of {TOKENIZERS}")
        size = int(mix["batch"])
        s = corpus.sentences
        self.batches = [s[i:i + size] for i in range(0, len(s), size)]
        self.batch_bytes = [sum(len(t.encode("utf-8")) for t in b)
                            for b in self.batches]
        self.vocab = load_vocab(config)
        import subword_tokenizers_tpu_torch as port
        self.cls = getattr(port, name)
        self.device = device
        self.tok = self.load(os.path.join(ROOT, config["vocab"]))
        self.next = 0

    def load(self, path: str):
        """A tokenizer on the device, loaded from ``path`` as users load
        one."""
        tok = self.cls(device=self.device)
        tok.load_resources(path, strict=True)
        return tok

    def warm(self) -> None:
        """Every batch once: each shape the window will use."""
        for _ in self.batches:
            self.once()

    def once(self) -> Tuple[int, List[List[str]]]:
        """The next batch encoded: (its index, its token lists)."""
        i = self.next
        self.next = (i + 1) % len(self.batches)
        return i, self.tok.tokenize_batch(self.batches[i])

    def keep(self, output) -> Tuple[int, str]:
        """(batch index, digest of its token lists)."""
        i, lists = output
        return i, fastwp.digest(lists)

    def route_error(self, phases: dict) -> Optional[str]:
        missing = [n for n in ROUTE if n not in phases]
        if missing:
            return (f"took another route than the fused native one (no "
                    f"span {', '.join(missing)})")
        return None

    def reference(self, record_states: bool = False) -> "Reference":
        """The plain encoder of the vocabulary."""
        return Reference(self)

    def wrong(self, kept, expected: "Reference") -> int:
        """How many kept calls differ from the plain encoder's."""
        return sum(1 for i, d in kept if d != expected.digest(i))


class Reference:
    """The plain encoder's digest of each batch, made when first asked."""

    def __init__(self, task: Task) -> None:
        self.task = task
        self.encoder = fastwp.FastWordPiece(task.vocab)
        self.digests: Dict[int, str] = {}

    def digest(self, i: int) -> str:
        if i not in self.digests:
            self.digests[i] = fastwp.digest(
                self.encoder.tokenize_batch(self.task.batches[i]))
        return self.digests[i]

    def scan_work(self, i: int) -> Dict[str, int]:
        """The work of batch ``i``'s fused scan (fastwp.scan_rows)."""
        return fastwp.scan_rows(self.encoder, self.task.batches[i])


def control(task: Task) -> None:
    """Turn ``task`` into the control: its tokenizer loaded with the
    longest entry that starts a word (no ``##``) left out."""
    word = max((t for t in task.vocab if not t.startswith("##")),
               key=lambda t: (len(t), t))
    with tempfile.TemporaryDirectory() as d:
        with open(os.path.join(d, "vocab.json"), "w",
                  encoding="utf-8") as f:
            json.dump([t for t in task.vocab if t != word], f,
                      ensure_ascii=False)
        task.tok = task.load(d)

"""The one generator of the benchmark's traffic: a training corpus drawn
from a source file by a traffic mix's parameters and the run's seed.

A mix (``portbench/traffic/<mix>.json``) gives:

- ``source``: the path of a JSON list of sentences, from the checkout's
  root;
- ``sha256``: that file's digest; any other file is refused;
- ``sentences``: how many sentences the corpus holds, each drawn
  uniformly from the source by ``random.Random(seed)``, with
  replacement.

The same seed gives the same corpus. Drawing with replacement keeps the
source's word types (nearly all, at the sizes used) but changes their
counts, so every seed trains other merges.
"""
from __future__ import annotations

import hashlib
import json
import os
import random
from dataclasses import dataclass
from typing import List

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@dataclass
class Corpus:
    """A drawn corpus: the sentences, and which source sentence each is."""

    sentences: List[str]
    source: List[str]
    draw: List[int]


def load_source(mix: dict) -> List[str]:
    """The mix's source sentences, after checking the file's digest."""
    path = os.path.join(ROOT, mix["source"])
    with open(path, "rb") as f:
        raw = f.read()
    digest = hashlib.sha256(raw).hexdigest()
    if digest != mix["sha256"]:
        raise ValueError(f"{mix['source']}: sha256 {digest}, the mix "
                         f"wants {mix['sha256']}")
    source = json.loads(raw.decode("utf-8"))
    if not isinstance(source, list) or not all(
            isinstance(s, str) for s in source):
        raise ValueError(f"{mix['source']}: not a JSON list of strings")
    return source


def draw(mix: dict, seed: int, source: List[str] = None) -> Corpus:
    """The corpus of ``mix`` for ``seed`` (``source``: the mix's source,
    when already loaded)."""
    if source is None:
        source = load_source(mix)
    n = int(mix["sentences"])
    rng = random.Random(seed)
    idx = [int(len(source) * rng.random()) for _ in range(n)]
    return Corpus(sentences=[source[i] for i in idx], source=source,
                  draw=idx)

"""Dataset tooling, the JAX package's ``data/build.py``.

Downloads the NKJP1M Polish corpus (`ipipan/nlprepl`, config
``by_name-nkjp-conllu``) from the HuggingFace hub, combines the splits and
writes ``data/train.json``: a JSON list of sentence strings, the input
every trainer and the CLI take.

The hub is needed only by :func:`main`, which raises a clear error when
the ``datasets`` package is missing; ``build_dataset`` works on any split
dict already in memory.
"""
from __future__ import annotations

import json
import os
from itertools import islice
from typing import Any, Dict, List, Optional

DATASET = "ipipan/nlprepl"
CONFIG = "by_name-nkjp-conllu"
SPLITS = ["train", "test", "validation"]


def build_dataset(dataset_splits: Dict[str, Any], feature_name: str,
                  num_examples: Optional[int] = None) -> List[str]:
    """Combine split iterables into one list of the non-null
    ``feature_name`` values, splits in dict order, capped at
    ``num_examples``. The reference's quirk is kept: it checks the cap
    after appending, so ``num_examples <= 0`` still yields one element
    when any exists."""
    texts = (value
             for split in dataset_splits.values()
             for example in split
             if (value := example.get(feature_name)) is not None)
    return list(texts if num_examples is None
                else islice(texts, max(num_examples, 1)))


def main(output_path: str = "data/train.json",
         num_examples: Optional[int] = None) -> None:
    """Download all splits and write the combined corpus."""
    try:
        from datasets import load_dataset
    except ImportError as e:
        raise RuntimeError(
            "the `datasets` package is required to download corpora; "
            "install it or provide a local JSON corpus") from e

    dataset_splits = {
        split: load_dataset(DATASET, name=CONFIG, split=split)
        for split in SPLITS
    }
    combined = build_dataset(dataset_splits, feature_name="text",
                             num_examples=num_examples)
    print("Splits combined." if combined else "No data loaded.")
    os.makedirs(os.path.dirname(output_path) or ".", exist_ok=True)
    with open(output_path, "w", encoding="utf-8") as f:
        json.dump(combined, f, ensure_ascii=False, indent=2)
    print(f"Saved {len(combined)} examples to {output_path}")


if __name__ == "__main__":
    main()

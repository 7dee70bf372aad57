"""Command-line interface of the port, flag for flag the JAX package's
(and so the reference's):

    python3 -m subword_tokenizers_tpu_torch.cli --model NaiveBPE FastBPE \\
        --train data/train.json --max_vocab 1000 --save my_dir

The same flags, defaults, printed lines and resource layout
(``resources/<dir>/<ModelName>/``). The tokenizers run on the card:
``main(argv, device="cuda")`` is what the command line calls, and
``device="cpu"`` runs the kernels' plain versions (the tests). There is
no ``--device`` flag, as the JAX CLI has none; on a machine without
CUDA, ``main`` raises as the constructors do.

The default normalization (``--normalize_with bert-base-uncased``) is
the built-in exact front end, with no network; any other model id loads
that HF tokenizer and pre-tokenizes through it, as the reference does.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
from argparse import RawTextHelpFormatter
from functools import partial

from . import TOKENIZERS
from .benchmarks.suite import benchmarks

MyFormatter = partial(RawTextHelpFormatter, max_help_position=70, width=100)
CMD = "python3 -m subword_tokenizers_tpu_torch.cli"


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="cli.py",
        description=(
            "Subword Tokenizers CLI (PyTorch and CUDA)\n\n"
            "Train and/or tokenize text using various subword tokenizers.\n"
        ),
        formatter_class=MyFormatter,
        epilog=(
            "Usage examples:\n\n"
            "Training:\n"
            f"  {CMD} --model NaiveBPE FastBPE --train data/train.json "
            "--max_vocab 1000\n"
            f"  {CMD} --model NaiveBPE --train data/train.json "
            "--save my_merges_dir\n\n"
            "Tokenization:\n"
            f"  {CMD} --model FastBPE --pretrained my_merges_dir "
            "--tokenize data/test.json\n\n"
            "Benchmarking:\n"
            f"  {CMD} --model NaiveBPE FastBPE --pretrained my_merges_dir "
            "--benchmark data/test.json [--compare]\n\n"
            "Resetting:\n"
            f"  {CMD} --model NaiveBPE --reset testing_dir\n"
        ),
    )
    parser.add_argument(
        "-m", "--model", choices=TOKENIZERS, nargs="+",
        metavar=("MODEL1", "MODEL2"), required=True,
        help=("select primary tokenizer model (required) and optional other "
              f"models for comparison: {', '.join(TOKENIZERS.keys())}"))
    parser.add_argument(
        "--normalize_with", type=str, metavar="HF_TOKENIZER",
        default="bert-base-uncased",
        help=("select normalization pipeline (default: 'bert-base-uncased', "
              "served by the built-in exact front end)"))
    parser.add_argument(
        "--train", type=str, metavar="TRAIN_DATA",
        help="path to .json file used for training")
    parser.add_argument(
        "--save", type=str, metavar="PATH",
        help="save training merges/vocab in specified path for later use")
    parser.add_argument(
        "--pretrained", type=str, metavar="PATH",
        help="load pretrained merges and vocabulary from specified path")
    parser.add_argument(
        "--tokenize", type=str, metavar="TEST_DATA",
        help="string to tokenize or path to .json file for tokenization")
    parser.add_argument(
        "-v", "--max_vocab", type=int, metavar="INTEGER", default=1_000,
        help="maximum vocabulary size for training (default: 1000)")
    parser.add_argument(
        "-b", "--benchmark", type=str, metavar="INPUT",
        help=("benchmark the selected tokenizer(s)\n"
              "-\twith --pretrained, INPUT is test data (string or .json)\n"
              "-\twithout, INPUT is training data (.json)\n"
              "-\tuse --compare for token-sequence equivalence"))
    parser.add_argument(
        "-c", "--compare", action="store_true",
        help="with --pretrained, only run token-sequence equivalence")
    parser.add_argument(
        "--reset", type=str, metavar="PATH",
        help="delete the saved resources directory for selected models")
    return parser


def _make_frontend(normalize_with: str):
    """None = built-in exact front end; else an HF tokenizer object."""
    if normalize_with == "bert-base-uncased":
        return None
    from transformers import AutoTokenizer
    return AutoTokenizer.from_pretrained(normalize_with)


def main(argv=None, *, device="cuda") -> None:
    parser = build_parser()
    args = parser.parse_args(argv)

    frontend = _make_frontend(args.normalize_with)

    if args.reset:
        for model_name in args.model:
            resource_path = os.path.join("resources", args.reset, model_name)
            if os.path.isdir(resource_path):
                shutil.rmtree(resource_path)
                print(f"Reset resources for {model_name}")
            else:
                print(f"No resources to reset for {model_name}")
        return

    tokenizer_instances = {
        name: TOKENIZERS[name](frontend, device=device) for name in args.model
    }

    if args.pretrained:
        for name, tok in tokenizer_instances.items():
            resource_path = os.path.join("resources", args.pretrained, name)
            tok.load_resources(resource_path)
            print(f"Loaded saved merges and vocab for {name} "
                  f"from {resource_path}")

    print(f"Loaded tokenizer model(s): "
          f"{', '.join(tokenizer_instances.keys())}")

    if args.train:
        with open(args.train, "r", encoding="utf-8") as f:
            corpus = json.load(f)
        for name, tok in tokenizer_instances.items():
            print(f"Training {name} with max_vocab={args.max_vocab} "
                  f"on {len(corpus)} examples...")
            tok.train(corpus, args.max_vocab, progress=True)
            if args.save:
                resource_path = os.path.join("resources", args.save, name)
                tok.save_resources(resource_path)
                print(f"Saved merges and vocab for {name} "
                      f"to {resource_path}")

    if args.tokenize:
        print("Tokenizing input...")
        from_file = (os.path.isfile(args.tokenize)
                     and args.tokenize.lower().endswith(".json"))
        if from_file:
            with open(args.tokenize, "r", encoding="utf-8") as f:
                inputs = json.load(f)
        else:
            inputs = [args.tokenize]
        output = {}
        for name, tok in tokenizer_instances.items():
            output[name] = tok.tokenize_batch(inputs)
        # Per example, then per model, as the reference prints.
        for i in range(len(inputs)):
            for name in tokenizer_instances:
                print(f"[{name}] {output[name][i]}")
        if from_file:
            out_path = args.tokenize.replace(".json", ".tokens.json")
            with open(out_path, "w", encoding="utf-8") as f:
                json.dump(output, f, ensure_ascii=False, indent=2)
            print(f"Tokenized output written to {out_path}")

    if args.benchmark:
        b_arg = args.benchmark
        if args.pretrained:
            if os.path.isfile(b_arg) and b_arg.lower().endswith(".json"):
                with open(b_arg, "r", encoding="utf-8") as f:
                    test_inputs = json.load(f)
            else:
                test_inputs = [b_arg]
            train_inputs = []
        else:
            if not os.path.isfile(b_arg) or not b_arg.lower().endswith(
                    ".json"):
                parser.error("--benchmark requires TRAIN_INPUT to be a "
                             "valid .json file path")
            with open(b_arg, "r", encoding="utf-8") as f:
                train_inputs = json.load(f)
            test_inputs = []

        model_names = list(tokenizer_instances.keys())
        models = list(tokenizer_instances.values())
        primary, primary_name = models[0], model_names[0]
        others = models[1:]

        if args.compare and not args.pretrained:
            parser.error("--compare may only be used with --pretrained")
        if args.compare and len(models) < 2:
            parser.error("--compare requires at least two tokenizers")

        header = (f"Benchmarking {primary_name}"
                  if not others else
                  f"Benchmarking {primary_name} vs "
                  f"{' vs '.join(model_names[1:])} ")
        print(f"{header} "
              f"{'(pretrained)' if args.pretrained else ''}"
              f"{'' if not train_inputs else f'with {len(train_inputs)} training examples'}...")
        benchmarks(
            tokenizer=primary,
            max_vocab_size=args.max_vocab,
            test_corpus=test_inputs,
            train_corpus=train_inputs,
            pretrained=bool(args.pretrained),
            pretrained_path=args.pretrained,
            reference_tokenizers=others,
            compare_only=args.compare,
        )
        print()

    if args.save:
        for name, tok in tokenizer_instances.items():
            resource_path = os.path.join("resources", args.save, name)
            tok.save_resources(resource_path)
            print(f"Saved merges and vocab for {name} to {resource_path}")


if __name__ == "__main__":
    main()

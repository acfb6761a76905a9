"""`python -m pipeinfer_tpu_torch.tools.tokenize` — tokenize text with a model's
vocab (ref: examples/tokenize).

A copy of pipeinfer_tpu.tools.tokenize, which imports no JAX (host only)."""

from __future__ import annotations

import argparse
import sys

from ..gguf.reader import GGUFReader
from ..tokenizer import tokenizer_from_gguf


def main(argv=None):
    p = argparse.ArgumentParser("pipeinfer-tokenize", description=__doc__)
    p.add_argument("-m", "--model", required=True)
    p.add_argument("text", nargs="?", default=None)
    p.add_argument("--no-bos", action="store_true")
    p.add_argument("--ids-only", action="store_true")
    args = p.parse_args(argv)
    with GGUFReader(args.model) as r:
        tok = tokenizer_from_gguf(r)
    text = args.text if args.text is not None else sys.stdin.read()
    ids = tok.encode(text, add_bos=not args.no_bos)
    if args.ids_only:
        print(" ".join(map(str, ids)))
    else:
        for i in ids:
            print(f"{i:>8d} -> {tok.piece(i)!r}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""`python -m pipeinfer_tpu_torch.tools.gguf_dump` — inspect a GGUF file
(ref: examples/gguf + gguf-py dump): metadata K/V and the tensor directory.

A copy of pipeinfer_tpu.tools.gguf_dump, which imports no JAX (host only)."""

from __future__ import annotations

import argparse
import sys

import numpy as np

from ..gguf.reader import GGUFReader


def main(argv=None):
    p = argparse.ArgumentParser("pipeinfer-gguf-dump", description=__doc__)
    p.add_argument("path")
    p.add_argument("--no-tensors", action="store_true")
    args = p.parse_args(argv)
    r = GGUFReader(args.path)
    print(f"{r.path}: GGUF v{r.version}, arch={r.architecture!r}, "
          f"{len(r.tensors)} tensors, {len(r.metadata)} kv, align={r.alignment}")
    for k, v in r.metadata.items():
        if isinstance(v, (list, np.ndarray)) and len(v) > 8:
            desc = f"[{len(v)} items] {list(v[:4])!r}..."
        else:
            desc = repr(v)
        print(f"  kv  {k} = {desc}")
    if not args.no_tensors:
        total = 0
        for info in r.tensor_order:
            print(f"  tns {info.name:40s} {str(info.shape):>18s} {info.qtype.name:5s} {info.n_bytes:>12,d}B")
            total += info.n_bytes
        print(f"  total tensor bytes: {total:,d}")
    r.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())

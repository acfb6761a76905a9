"""`python -m pipeinfer_tpu_torch.tools.export_lora` — merge LoRA adapters into a base GGUF
(ref: examples/export-lora/export-lora.cpp: -m base, -o out, repeatable
-l adapter / -s adapter scale). Metadata and non-adapted tensors are copied
byte-for-byte (quantized payloads untouched); adapted tensors are
dequantized, get `scale * (alpha/r) * B @ A` added, and are written F32
(the reference likewise warns that merging into quantized weights loses
precision — we sidestep it by densifying exactly the adapted tensors).

Port of pipeinfer_tpu.tools.export_lora: each adapter's delta is computed
on `device` (default cuda); on the CPU the file is the JAX package's, byte
for byte."""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..device import resolve
from ..gguf.reader import GGUFReader
from ..gguf.writer import GGUFWriter
from .lora import SLOT2GGUF, load_adapter


def merge_file(base_path: str, out_path: str, adapters: list[tuple[str, float]],
               device=None):
    # accumulate per-tensor deltas across all adapters (ref applies them
    # sequentially; addition commutes)
    dev = resolve(device)
    deltas: dict[str, np.ndarray] = {}
    for path, scale in adapters:
        alpha, rank, pairs = load_adapter(path)
        s = scale * (alpha / rank)
        for (layer, slot), (a, b) in pairs.items():
            name = f"blk.{layer}.{SLOT2GGUF[slot]}.weight"
            ba = torch.from_numpy(b).to(dev) @ torch.from_numpy(a).to(dev)
            d = (float(np.float32(s)) * ba).cpu().numpy()
            deltas[name] = deltas.get(name, 0) + d

    with GGUFReader(base_path) as r:
        w = GGUFWriter(out_path, arch=r.architecture)
        for key, val in r.metadata.items():
            if key in ("general.architecture", "general.alignment"):
                continue
            w.add_kv(key, val)
        n_merged = 0
        for name, info in r.tensors.items():
            if name in deltas:
                dense = np.asarray(r.tensor(name), np.float32)
                if dense.shape != deltas[name].shape:
                    raise SystemExit(
                        f"error: adapter shape {deltas[name].shape} does not "
                        f"match {name} {dense.shape}"
                    )
                w.add_tensor(name, dense + deltas[name])
                n_merged += 1
            else:
                w.add_tensor(name, bytes(r.tensor_bytes(name)),
                             shape=info.shape, qtype=info.qtype)
        missing = set(deltas) - set(r.tensors)
        if missing:
            raise SystemExit(f"error: adapter tensors not in base model: {sorted(missing)}")
        w.write()
    return n_merged


def main(argv=None):
    p = argparse.ArgumentParser("pipeinfer-export-lora", description=__doc__)
    p.add_argument("-m", "--model-base", required=True)
    p.add_argument("-o", "--model-out", required=True)
    p.add_argument("-l", "--lora", action="append", default=[],
                   metavar="FNAME", help="apply LoRA adapter (repeatable)")
    p.add_argument("-s", "--lora-scaled", action="append", default=[], nargs=2,
                   metavar=("FNAME", "S"), help="apply adapter with scale S")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = p.parse_args(argv)

    adapters = [(f, 1.0) for f in args.lora]
    adapters += [(f, float(s)) for f, s in args.lora_scaled]
    if not adapters:
        raise SystemExit("error: no adapters given (use -l or -s)")
    n = merge_file(args.model_base, args.model_out, adapters, device=args.device)
    print(f"merged {n} tensors from {len(adapters)} adapter(s) -> {args.model_out}",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())

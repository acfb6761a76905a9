"""`python -m pipeinfer_tpu_torch.tools.quantize_stats` — per-format quantization
error statistics over a model's weights (ref: examples/quantize-stats):
RMSE and max error of each format applied to each 2-D tensor.

A copy of pipeinfer_tpu.tools.quantize_stats, which imports no JAX: the
port's numpy codecs on the host."""

from __future__ import annotations

import argparse
import sys

import numpy as np

from ..gguf.constants import GGMLQuantType
from ..gguf.reader import GGUFReader
from ..quant import formats
from .quantize import FTYPES


def main(argv=None):
    p = argparse.ArgumentParser("pipeinfer-quantize-stats", description=__doc__)
    p.add_argument("-m", "--model", required=True)
    p.add_argument("--ftypes", default="q4_0,q4_k,q5_k,q6_k,q8_0")
    p.add_argument("--per-tensor", action="store_true")
    args = p.parse_args(argv)
    r = GGUFReader(args.model)
    ftypes = [FTYPES[f] for f in args.ftypes.split(",")]
    for qt in ftypes:
        if qt in (GGMLQuantType.F32, GGMLQuantType.F16):
            continue
        sq_sum = 0.0
        n_total = 0
        max_err = 0.0
        for info in r.tensor_order:
            if len(info.shape) != 2 or info.shape[-1] % 256 != 0:
                continue
            x = np.asarray(r.tensor(info.name), np.float32).reshape(-1)
            y = formats.dequantize(formats.quantize(x, qt), qt)
            d = x - y
            sq_sum += float((d * d).sum())
            n_total += x.size
            m = float(np.abs(d).max())
            max_err = max(max_err, m)
            if args.per_tensor:
                print(f"  {qt.name:5s} {info.name:40s} rmse {np.sqrt((d*d).mean()):.6f} max {m:.6f}")
        if n_total:
            print(f"{qt.name:5s}: rmse {np.sqrt(sq_sum / n_total):.6f}  max {max_err:.6f}  ({n_total:,d} weights)")
    r.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())

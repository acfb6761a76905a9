"""`python -m pipeinfer_tpu_torch.tools.quantize` — requantize a GGUF model file
(ref: examples/quantize/quantize.cpp): copies metadata, re-encodes 2-D
weight tensors to the requested format (norms/embeddings rules follow the
reference's defaults: output and token_embd may use a higher-precision
format; 1-D tensors stay F32).

Port of pipeinfer_tpu.tools.quantize: numpy on the host, as there, with
the rounding of quant/formats.py in the port's native runtime (native.py)
where the JAX package rounds in its own, so every output file is the JAX
package's byte for byte. `--device` is resolved as by every entry point of
the port (without CUDA, pass --device cpu); nothing here runs on it."""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from ..device import resolve
from ..gguf.constants import GGMLQuantType, Keys
from ..gguf.reader import GGUFReader
from ..gguf.writer import GGUFWriter
from ..quant import formats

FTYPES = {
    "f32": GGMLQuantType.F32,
    "f16": GGMLQuantType.F16,
    "q4_0": GGMLQuantType.Q4_0,
    "q4_1": GGMLQuantType.Q4_1,
    "q5_0": GGMLQuantType.Q5_0,
    "q5_1": GGMLQuantType.Q5_1,
    "q8_0": GGMLQuantType.Q8_0,
    "q2_k": GGMLQuantType.Q2_K,
    "q3_k": GGMLQuantType.Q3_K,
    "q4_k": GGMLQuantType.Q4_K,
    "q5_k": GGMLQuantType.Q5_K,
    "q6_k": GGMLQuantType.Q6_K,
}


def quantize_file(
    src: str,
    dst: str,
    qtype: GGMLQuantType,
    *,
    output_qtype: GGMLQuantType | None = None,
    log=lambda *a: None,
):
    r = GGUFReader(src)
    w = GGUFWriter(dst, r.architecture)
    for key, val in r.metadata.items():
        if key == Keys.ARCHITECTURE:
            continue
        w.add_kv(key, val)
    w.add_kv(Keys.FILE_TYPE, int(qtype))

    out_q = output_qtype or (
        GGMLQuantType.Q6_K if qtype.name.endswith("_K") else GGMLQuantType.Q8_0
    )
    for info in r.tensor_order:
        t0 = time.time()
        data = r.tensor(info.name)  # dequantized float
        if len(info.shape) != 2 or info.shape[-1] % 256 != 0:
            tq = GGMLQuantType.F32
        elif info.name in ("output.weight",):
            tq = out_q  # ref: output kept higher precision
        else:
            tq = qtype
        if tq in (GGMLQuantType.F32, GGMLQuantType.F16):
            w.add_tensor(info.name, np.asarray(data), qtype=tq)
        else:
            payload = formats.quantize(np.asarray(data, np.float32).reshape(-1), tq)
            w.add_tensor(info.name, payload.tobytes(), shape=info.shape, qtype=tq)
        log(f"  {info.name}: {info.qtype.name} -> {tq.name} ({time.time()-t0:.2f}s)")
    w.write()
    r.close()


def main(argv=None):
    p = argparse.ArgumentParser("pipeinfer-quantize", description=__doc__)
    p.add_argument("src")
    p.add_argument("dst")
    p.add_argument("ftype", choices=sorted(FTYPES), help="target quant format")
    p.add_argument("--output-ftype", choices=sorted(FTYPES), help="format for output.weight")
    p.add_argument("-q", "--quiet", action="store_true")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = p.parse_args(argv)
    resolve(args.device)
    log = (lambda *a: None) if args.quiet else (lambda *a: print(*a, file=sys.stderr))
    quantize_file(
        args.src,
        args.dst,
        FTYPES[args.ftype],
        output_qtype=FTYPES[args.output_ftype] if args.output_ftype else None,
        log=log,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())

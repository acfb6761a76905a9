"""Count the SASS instructions of a split-K kernel's main loop, by opcode.

    python -m pipeinfer_tpu_torch.tools.sass_count [--kernel qmatmul_kmajor]

Builds ``csrc/<kernel>.cu`` (default ``qmatmul_i8``; also ``qmatmul_i4g``,
``qmatmul_i8g``, ``qmatmul_kmajor`` and ``qmatmul_k4``) with the port's
nvcc flags and ``-Xptxas -v`` into build/sass/, prints ptxas's register
and spill lines, disassembles the library with ``cuobjdump -sass`` and,
for every instance of the kernel's function (its name without
``qmatmul_``, then ``_kernel``), finds its largest loop (the span from a
backward branch's target, a label or an address, to the branch, holding
no EXIT) and counts the instructions in it by opcode (the mnemonic before
its first dot), per weight: one pass of the chunk loop takes 16 rows x 4
columns x the elements a row holds for one thread (i8 and i8g: 64
weights; i4g and k4: 128; k_major: 64 x 1, 2 or 4 planes by the
instance's bit width). These are static counts: a branch inside the
loop (the bias rows, the prefetch of the next chunk) counts whether it is
taken or not. Needs the CUDA toolkit; writes the SASS (``<kernel>.sass``)
and the counts (``<kernel>.json``) beside the library in build/sass/.
"""
from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import sys
from collections import Counter
from pathlib import Path

from ..ops import cuda_build
from ..ops.qmatmul import _QS_ROWS

ROOT = Path(__file__).resolve().parents[2]
KERNELS = ("qmatmul_i4g", "qmatmul_i8g", "qmatmul_i8", "qmatmul_kmajor",
           "qmatmul_k4")  # the split-frame ones
CH = 16  # rows a warp takes of each chunk in their loops (CH in csrc)
KINDS = ("I2F", "I2FP", "F2F", "F2FP", "PRMT", "FADD", "FMUL", "FFMA", "LOP3", "SHF", "IMAD",
         "IADD3", "LDG", "LDS", "LDGSTS", "BRA")
_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
_TARGET = re.compile(r"`\((\.L_x_\d+)\)|\s(0x[0-9a-f]+)\s*$")  # a label, or an address


def _tool(name: str) -> str:
    found = shutil.which(name)
    if found:
        return found
    path = Path("/usr/local/cuda/bin") / name
    if path.exists():
        return str(path)
    raise RuntimeError(f"{name} not found: needs the CUDA toolkit")


def functions(sass: str) -> dict[str, list[str]]:
    """cuobjdump -sass text -> {mangled function name: its lines}."""
    out: dict[str, list[str]] = {}
    cur = None
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = out.setdefault(m.group(1), [])
        elif cur is not None:
            cur.append(line)
    return out


def loop_counts(lines: list[str]) -> tuple[Counter, int]:
    """Opcode counts of the largest loop in one function's SASS, and the
    loop's length in instructions."""
    insns: list[tuple[int, str]] = []  # (address, text)
    labels: dict[str, int] = {}
    pending: list[str] = []
    for line in lines:
        lab = _LABEL.match(line)
        if lab:
            pending.append(lab.group(1))
            continue
        m = _INSN.search(line)
        if m:
            addr = int(m.group(1), 16)
            for name in pending:
                labels[name] = addr
            pending = []
            insns.append((addr, m.group(2)))
    exits = [addr for addr, text in insns if text.split()[-1] == "EXIT"]
    best = None
    for addr, text in insns:
        t = _TARGET.search(text)
        if not t or "BRA" not in text:
            continue
        target = labels.get(t.group(1)) if t.group(1) else int(t.group(2), 16)
        # a loop's back edge; a span holding an EXIT is an out-of-line path
        # (such as BRA.DIV's) jumping back into the body, not a loop
        if target is None or target >= addr or any(target <= e <= addr for e in exits):
            continue
        if best is None or addr - target > best[1] - best[0]:
            best = (target, addr)
    if best is None:
        return Counter(), 0
    body = [text for addr, text in insns if best[0] <= addr <= best[1]]
    ops = Counter()
    for text in body:
        words = text.split()
        if words and words[0].startswith("@"):
            words = words[1:]
        if words:
            ops[words[0].split(".")[0]] += 1
    return ops, len(body)


def weights_per_pass(kernel: str, name: str) -> int:
    """Weights one pass of the chunk loop takes for one thread in instance
    `name` (mangled) of `kernel`: CH rows x 4 columns x the elements a row
    holds (two nibbles at i4g and k4; at k_major the planes of the
    instance's bit width, its first template argument)."""
    if kernel == "qmatmul_kmajor":
        elems = _QS_ROWS[int(re.search(r"ILi(\d+)E", name).group(1))]
    else:
        elems = 2 if kernel in ("qmatmul_i4g", "qmatmul_k4") else 1
    return 4 * CH * elems


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", default="qmatmul_i8", choices=KERNELS, help="csrc/<KERNEL>.cu")
    kernel = ap.parse_args(argv).kernel
    function = f"{kernel.removeprefix('qmatmul_')}_kernel"
    source = cuda_build.CSRC / f"{kernel}.cu"
    out_dir = ROOT / "build" / "sass"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / f"lib{kernel}.so"
    cmd = [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(lib),
           str(source)]
    built = subprocess.run(cmd, capture_output=True, text=True)
    if built.returncode != 0:
        print(built.stdout + built.stderr, file=sys.stderr)
        return 1
    for line in (built.stdout + built.stderr).splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(line.strip())
    sass = subprocess.run([_tool("cuobjdump"), "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    (out_dir / f"{kernel}.sass").write_text(sass)
    report = {}
    for name, lines in functions(sass).items():
        if function not in name:
            continue
        ops, n = loop_counts(lines)
        per_iter = weights_per_pass(kernel, name)
        per = {k: v / per_iter for k, v in sorted(ops.items())}
        report[name] = dict(loop_instructions=n, weights=per_iter, counts=dict(ops),
                            per_weight=per)
        print(f"{name}: loop of {n} instructions, {per_iter} weights, "
              f"{n / per_iter:.2f} per weight")
        print("    " + "  ".join(f"{k} {ops.get(k, 0) / per_iter:.3f}" for k in KINDS))
        rest = {k: v for k, v in ops.items() if k not in KINDS}
        if rest:
            print("    other: " + "  ".join(f"{k} {v / per_iter:.3f}"
                                            for k, v in sorted(rest.items())))
    (out_dir / f"{kernel}.json").write_text(json.dumps(report, indent=1))
    return 0 if report else 1


if __name__ == "__main__":
    sys.exit(main())

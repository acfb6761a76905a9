"""`python -m pipeinfer_tpu_torch.cli.infill` — fill-in-middle code completion
(ref: examples/infill/infill.cpp): requires a FIM-capable vocabulary
(prefix/suffix/middle special tokens, e.g. CodeLlama); the prompt is
assembled as `<bos><fim_pre>{prefix}<fim_suf>{suffix}<fim_mid>` and
generation stops at EOS or the end-of-text special. One-shot mode of the
reference driver; the shared implementation lives in cli/main.py.

A copy of pipeinfer_tpu.cli.infill over the port's cli.main."""

from __future__ import annotations

import sys

from .main import main as _main


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    has_pre = any(a == "--in-prefix" for a in argv)
    has_suf = any(a == "--in-suffix" for a in argv)
    if not (has_pre or has_suf):
        print("error: infill needs --in-prefix and/or --in-suffix", file=sys.stderr)
        return 1
    if has_pre != has_suf:  # one side empty is fine, but make it explicit
        argv += ["--in-suffix", ""] if has_pre else ["--in-prefix", ""]
    return _main(argv)


if __name__ == "__main__":
    sys.exit(main())

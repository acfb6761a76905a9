"""`pipeinfer-preset` — run a CLI with parameters from YAML preset files
(ref: run_with_preset.py): keys map to long flags (underscores → dashes),
booleans become bare flags, lists join with commas; command-line arguments
after the presets override preset values. The first positional selects the
binary (main / speculative / server / perplexity / batched / batched-bench
/ bench).

A copy of pipeinfer_tpu.tools.preset whose KNOWN table names the port's
entry points (pass `device: cpu` in a preset, or `--device cpu` after it,
to run them without CUDA)."""

from __future__ import annotations

import argparse
import sys

KNOWN = {
    "main": "pipeinfer_tpu_torch.cli.main",
    "speculative": "pipeinfer_tpu_torch.cli.speculative",
    "pipeline": "pipeinfer_tpu_torch.cli.pipeline",
    "server": "pipeinfer_tpu_torch.serving.server",
    "perplexity": "pipeinfer_tpu_torch.tools.perplexity",
    "bench": "pipeinfer_tpu_torch.tools.bench",
    "batched": "pipeinfer_tpu_torch.tools.batched",
    "batched-bench": "pipeinfer_tpu_torch.tools.batched_bench",
}


def preset_to_argv(doc: dict) -> list[str]:
    argv = []
    for k, v in doc.items():
        flag = "--" + str(k).replace("_", "-")
        if isinstance(v, bool):
            if v:
                argv.append(flag)
        elif isinstance(v, list):
            argv += [flag, ",".join(str(x) for x in v)]
        else:
            argv += [flag, str(v)]
    return argv


def main(argv=None):
    p = argparse.ArgumentParser("pipeinfer-preset", description=__doc__)
    p.add_argument("binary", choices=sorted(KNOWN))
    p.add_argument("presets", nargs="+", help="YAML preset file(s), merged in order")
    p.add_argument("extra", nargs=argparse.REMAINDER,
                   help="extra CLI args appended after preset-derived ones (override)")
    args = p.parse_args(argv)

    import importlib

    import yaml

    merged: dict = {}
    for path in args.presets:
        try:
            with open(path) as f:
                doc = yaml.safe_load(f) or {}
        except OSError as e:
            raise SystemExit(f"error: cannot read preset {path}: {e}")
        except yaml.YAMLError as e:
            raise SystemExit(f"error: invalid YAML in {path}: {e}")
        if not isinstance(doc, dict):
            raise SystemExit(f"error: {path} is not a YAML mapping")
        merged.update(doc)

    child_argv = preset_to_argv(merged) + list(args.extra)
    mod = importlib.import_module(KNOWN[args.binary])
    print(f"{args.binary} {' '.join(child_argv)}", file=sys.stderr)
    return mod.main(child_argv)


if __name__ == "__main__":
    sys.exit(main())

"""YAML run dumps (ref: common/common.cpp dump_non_result_info_yaml + the
--logdir UX of examples/main and examples/server): one timestamped .yml per
run capturing the resolved CLI parameters, prompt/output token ids and text,
and the context's timing counters — the reproducibility record the
reference writes for sweep post-processing.

A copy of pipeinfer_tpu.utils.rundump (which imports no JAX): the same
document for the same run."""

from __future__ import annotations

import datetime
import os
import platform
import sys


def dump_run_yaml(logdir: str, *, args: dict, prompt_ids, output_ids,
                  output_text: str, ctx=None) -> str:
    import yaml

    os.makedirs(logdir, exist_ok=True)
    stamp = datetime.datetime.now().strftime("%Y%m%d-%H%M%S-%f")
    path = os.path.join(logdir, f"run-{stamp}.yml")
    doc = {
        "build_info": {
            "python": sys.version.split()[0],
            "platform": platform.platform(),
        },
        "params": {k: v for k, v in sorted(args.items()) if not callable(v)},
        "prompt_tokens": list(map(int, prompt_ids)),
        "output_tokens": list(map(int, output_ids)),
        "output": output_text,
    }
    if ctx is not None:
        doc["timings"] = {
            "n_prefill": int(getattr(ctx, "n_prefill", 0)),
            "t_prefill_s": float(getattr(ctx, "t_prefill", 0.0)),
            "n_eval": int(getattr(ctx, "n_eval", 0)),
            "t_eval_s": float(getattr(ctx, "t_eval", 0.0)),
        }
    with open(path, "w") as f:
        yaml.safe_dump(doc, f, sort_keys=False, allow_unicode=True)
    return path

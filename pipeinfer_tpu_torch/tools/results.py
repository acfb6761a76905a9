"""Summarize results.csv runs and render the comparison charts
(ref: plot.py — bar-charts of Speed/ITL/TTFT per
{Sequential, Speculative, PipeInfer} × model). Rows labeled "model:impl"
(e.g. "7b:PipeInfer") are grouped exactly like the reference's charts;
other labels get one bar each.

A copy of pipeinfer_tpu.tools.results, which imports no JAX (host only)."""

from __future__ import annotations

import argparse
import sys


def load(path: str) -> list[dict]:
    """Load results.csv rows. ONE schema: 5 labeled fields
    (encode t/s, decode t/s, avg ITL s, TTFT s incl. prefill, label) —
    the file is rejected if rows mix field counts (a mixed file means two
    writers disagreed; silently grouping them would chart apples against
    oranges)."""
    rows = []
    widths = set()
    with open(path) as f:
        for ln, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            parts = line.split(",")
            if len(parts) < 4:
                raise SystemExit(
                    f"{path}:{ln}: malformed row ({len(parts)} fields)"
                )
            widths.add(len(parts))
            if len(widths) > 1:
                raise SystemExit(
                    f"{path}:{ln}: mixed row schemas ({sorted(widths)} field "
                    "counts) — rewrite the file with the labeled 5-field "
                    "schema (PipeInferMetrics.csv_row)"
                )
            rows.append(
                {
                    "encode_tps": float(parts[0]),
                    "decode_tps": float(parts[1]),
                    "avg_itl_s": float(parts[2]),
                    "ttft_s": float(parts[3]),
                    "label": parts[4] if len(parts) > 4 else f"run{len(rows)}",
                }
            )
    return rows


def plot(rows: list[dict], out_path: str):
    """Render the reference's three-panel bar chart (ref: plot.py:33-48 —
    Speed / avg ITL / TTFT). Labels of the form "model:impl" are grouped
    with one bar color per model and impls along the x axis, exactly like
    the reference's {Sequential, Speculative, PipeInfer} comparison."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    panels = [
        ("Speed (tokens/s)", "decode_tps", 1.0),
        ("Avg inter-token latency (ms)", "avg_itl_s", 1e3),
        ("TTFT (ms)", "ttft_s", 1e3),
    ]
    fig, axes = plt.subplots(1, 3, figsize=(13, 4))

    grouped = all(":" in r["label"] for r in rows)
    if grouped:
        models, impls = [], []
        for r in rows:
            mdl, impl = r["label"].split(":", 1)
            if mdl not in models:
                models.append(mdl)
            if impl not in impls:
                impls.append(impl)
        width = 0.8 / max(1, len(models))
        for ax, (title, key, scale) in zip(axes, panels):
            for mi, mdl in enumerate(models):
                vals = []
                for impl in impls:
                    v = [r[key] * scale for r in rows
                         if r["label"] == f"{mdl}:{impl}"]
                    vals.append(v[-1] if v else 0.0)
                xs = [i + width * mi for i in range(len(impls))]
                bars = ax.bar(xs, vals, width, label=mdl)
                ax.bar_label(bars, padding=3, fmt="%.3g", fontsize=7)
            ax.set_xticks([i + width * (len(models) - 1) / 2 for i in range(len(impls))])
            ax.set_xticklabels(impls, fontsize=8)
            ax.set_title(title)
            ax.legend(fontsize=7)
    else:
        labels = [r["label"] for r in rows]
        for ax, (title, key, scale) in zip(axes, panels):
            vals = [r[key] * scale for r in rows]
            ax.bar(range(len(vals)), vals)
            ax.set_xticks(range(len(labels)))
            ax.set_xticklabels(labels, rotation=30, ha="right", fontsize=8)
            ax.set_title(title)
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)


def main(argv=None):
    p = argparse.ArgumentParser("pipeinfer-results", description=__doc__)
    p.add_argument("csv", help="results.csv path")
    p.add_argument("--plot", default="", metavar="PNG",
                   help="also render the plot.py-style bar charts to a PNG")
    args = p.parse_args(argv)
    try:
        rows = load(args.csv)
    except OSError as e:
        print(f"error: cannot read {args.csv}: {e}", file=sys.stderr)
        return 1
    if not rows:
        print("no rows", file=sys.stderr)
        return 1
    print(f"{'label':16s} {'encode t/s':>10s} {'decode t/s':>10s} {'avg ITL ms':>10s} {'TTFT ms':>8s}")
    for r in rows:
        print(
            f"{r['label']:16s} {r['encode_tps']:10.2f} {r['decode_tps']:10.2f} "
            f"{r['avg_itl_s'] * 1e3:10.1f} {r['ttft_s'] * 1e3:8.1f}"
        )
    if args.plot:
        plot(rows, args.plot)
        print(f"chart -> {args.plot}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())

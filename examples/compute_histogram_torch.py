#!/usr/bin/env python3
"""ASCII histogram + percentile report for colormap tuning, on the
PyTorch port.

The port's copy of ``compute_histogram.py``
(python/examples/compute_histogram.py): compute the normalized scalar
histogram used during rendering, print an ASCII bar chart and the
percentiles that help place colormap control points.  The bricks are
binned on the GPU unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import math
from typing import Optional, Sequence

import amrvolumerenderer_torch as avr


def ascii_histogram(counts, width: int = 60) -> str:
    total = sum(counts)
    if total == 0:
        return "(empty histogram)"
    peak = max(counts)
    lines = []
    for i, c in enumerate(counts):
        bar = "#" * (round(width * c / peak) if peak else 0)
        frac = 100.0 * c / total
        lines.append(f"{i:4d} | {bar:<{width}} {c:>10d} ({frac:5.2f}%)")
    return "\n".join(lines)


def percentiles(counts, edges, targets):
    total = sum(counts)
    out = {}
    if total == 0:
        return {t: float("nan") for t in targets}
    cumulative = 0
    remaining = sorted(targets)
    idx = 0
    for i, c in enumerate(counts):
        cumulative += c
        while idx < len(remaining) and cumulative >= remaining[idx] / 100.0 * total:
            out[remaining[idx]] = edges[i + 1]
            idx += 1
    for t in remaining[idx:]:
        out[t] = edges[-1]
    return out


def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("plotfile")
    parser.add_argument("--variable", default=None)
    parser.add_argument("--min-level", type=int, default=0)
    parser.add_argument("--max-level", type=int, default=-1)
    parser.add_argument("--log-scale", action="store_true")
    parser.add_argument("--bins", type=int, default=64)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    result = avr.compute_histogram(
        args.plotfile,
        variable=args.variable,
        min_level=args.min_level,
        max_level=args.max_level,
        log_scale=args.log_scale,
        bins=args.bins,
        device=args.device,
    )
    counts = result["counts"]
    lo, hi = result["normalized_range"]
    print(f"samples: {result['samples']}")
    print(f"normalized range: [{lo:g}, {hi:g}]")
    if result["processed_range"]:
        print(
            "processed range: "
            f"[{result['processed_range'][0]:g}, {result['processed_range'][1]:g}]"
        )
    if result["original_range"]:
        print(
            "original range:  "
            f"[{result['original_range'][0]:g}, {result['original_range'][1]:g}]"
        )
    print()
    print(ascii_histogram(counts))

    # percentile report in *physical* units for colormap placement
    if result["original_range"] and result["processed_range"]:
        p_lo, p_hi = result["processed_range"]
        edges = [
            p_lo + (p_hi - p_lo) * i / len(counts) for i in range(len(counts) + 1)
        ]
        if args.log_scale:
            edges = [math.exp(e) for e in edges]
        pct = percentiles(counts, edges, [1, 5, 25, 50, 75, 95, 99])
        print("\npercentiles (physical units):")
        for p, v in sorted(pct.items()):
            print(f"  p{p:<3} {v:.6g}")


if __name__ == "__main__":
    main()

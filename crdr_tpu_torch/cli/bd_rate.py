"""Bjontegaard-delta comparison of two RD-sweep CSVs (counterpart of
``scripts/bd_rate.py``: the same flags and JSON line).

Compares a test RD curve against an anchor curve at equal quality / rate.
Accepts both the reference CSV schema (``dataset,quality,beta,bpp,PSNR,
...``) and ``cli/rd_sweep.py``'s output (``quality,beta,bpp,psnr,ms_ssim``);
column names are matched case-insensitively.

Usage:
    python -m crdr_tpu_torch.cli.bd_rate ANCHOR.csv TEST.csv \\
        [--metric psnr] [--beta 3.84] [--anchor_beta ...] [--method akima]

Prints one JSON line: {"bd_rate_pct": ..., "bd_quality": ..., ...}.
Negative bd_rate_pct = the test codec spends fewer bits at equal quality.
"""

from __future__ import annotations

import argparse
import csv
import json
from typing import Dict, List, Optional, Tuple

from ..metrics.bd import bd_quality, bd_rate

# metrics where smaller is better (loss-like)
LOWER_BETTER = {"lpips", "dists", "fid"}


def read_curve(path: str, metric: str, beta: Optional[str]
               ) -> Tuple[List[float], List[float]]:
    with open(path, newline="") as f:
        rows = list(csv.DictReader(f))
    if not rows:
        raise SystemExit(f"{path}: empty CSV")
    cols = {c.lower(): c for c in rows[0].keys()}
    for need in ("bpp", metric):
        if need not in cols:
            raise SystemExit(
                f"{path}: no column {need!r} (have {sorted(cols)})")
    if beta is not None and "beta" in cols:
        want = float(beta)
        rows = [r for r in rows if float(r[cols["beta"]]) == want]
        if not rows:
            raise SystemExit(f"{path}: no rows with beta={beta}")
    rate, met = [], []
    for r in rows:
        m = r[cols[metric]]
        if m in ("", "nan", None):
            continue
        rate.append(float(r[cols["bpp"]]))
        met.append(float(m))
    return rate, met


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(description="BD-rate of two RD CSVs")
    ap.add_argument("anchor", help="anchor RD CSV (e.g. reference kodak.csv)")
    ap.add_argument("test", help="test RD CSV (e.g. rd_sweep output)")
    ap.add_argument("--metric", default="psnr",
                    help="metric column (case-insensitive): psnr, ms_ssim, "
                         "lpips, dists, fid ... (default psnr)")
    ap.add_argument("--beta", default=None,
                    help="filter BOTH curves to this beta (curves without a "
                         "beta column are used whole)")
    ap.add_argument("--anchor_beta", default=None,
                    help="beta filter for the anchor only (overrides --beta)")
    ap.add_argument("--test_beta", default=None,
                    help="beta filter for the test only (overrides --beta)")
    ap.add_argument("--method", default="akima", choices=["akima", "poly3"])
    args = ap.parse_args(argv)

    metric = args.metric.lower()
    higher = metric not in LOWER_BETTER
    ar, am = read_curve(args.anchor, metric, args.anchor_beta or args.beta)
    tr, tm = read_curve(args.test, metric, args.test_beta or args.beta)
    out = {
        "metric": metric,
        "higher_better": higher,
        "method": args.method,
        "anchor": args.anchor,
        "test": args.test,
        "anchor_points": len(ar),
        "test_points": len(tr),
        "bd_rate_pct": round(bd_rate(ar, am, tr, tm, higher, args.method), 3),
        "bd_quality": round(
            bd_quality(ar, am, tr, tm, higher, args.method), 5),
    }
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()

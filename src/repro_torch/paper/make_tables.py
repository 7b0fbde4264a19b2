"""Render the roofline markdown tables from the port's dry-run artifacts:
the port of ``benchmarks/make_tables.py``.

  PYTHONPATH=src python -m repro_torch.paper.make_tables

The reference's last column is the compile wall; the port's is the traced
step's wall, and a column says whether the cell's arguments and peak fit
an H100's 80 GB. Accounting figures from a trace, not timings of a run.
"""

from __future__ import annotations

import glob
import json
import os

DRYRUN_DIR = "experiments/dryrun_torch"


def table(pattern: str, title: str, dedup: bool = True) -> list:
    """Print one table; returns its rows."""
    rows = []
    seen = set()
    for f in sorted(glob.glob(pattern)):
        with open(f) as fh:
            d = json.load(fh)
        tag = os.path.basename(os.path.dirname(f))
        name = d["arch"].replace("-", "_").replace(".", "_")
        if not dedup:
            name = f"{name} ({tag})"
        key = (name, d["shape"])
        if key in seen:
            continue
        seen.add(key)
        if "skipped" in d:
            rows.append((key[0], key[1], "skip", "", "", "", "", "", "", ""))
            continue
        if "error" in d:
            rows.append((key[0], key[1], "ERROR", "", "", "", "", "", "", ""))
            continue
        t = d["terms_s"]
        rows.append((
            key[0], key[1], d["dominant"],
            f"{t['compute']:.3f}", f"{t['memory']:.3f}", f"{t['collective']:.3f}",
            f"{d['memory'].get('temp_size_in_bytes', 0)/1e9:.1f}",
            f"{d['useful_flops_ratio']:.2f}",
            "yes" if d.get("fits_80gb") else "no",
            f"{d.get('trace_s', 0):.0f}s",
        ))
    print(f"\n### {title}\n")
    print("| arch | shape | dominant | compute s | memory s | collective s | "
          "temp GB/dev | 6ND/counted | fits 80 GB | trace |")
    print("|---|---|---|---|---|---|---|---|---|---|")
    for r in sorted(rows):
        print("| " + " | ".join(str(x) for x in r) + " |")
    return rows


def main() -> None:
    table(f"{DRYRUN_DIR}/*_single.json", "Single-pod 16x16 (H100 roofline terms)")
    table(f"{DRYRUN_DIR}/*_multi.json", "Multi-pod 2x16x16 (shardability proof)")


if __name__ == "__main__":
    main()

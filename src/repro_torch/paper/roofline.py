"""Roofline table: the port of ``benchmarks/bench_roofline.py``.

Reads the port's dry-run artifacts (``experiments/dryrun_torch/*.json``,
written by ``python -m repro_torch.launch.dryrun --all``) and emits one
row per (arch x shape) cell on the single-pod mesh: the three terms on
H100 constants, the dominant bottleneck, the useful-FLOPs ratio and the
per-device temporaries. The reference's time column is its compile wall;
the port's is the traced step's wall (``trace_s``). Accounting figures
from a trace, not timings of a run.

    PYTHONPATH=src python -m repro_torch.paper.roofline
"""

from __future__ import annotations

import json
from pathlib import Path

from repro_torch import resolve_device
from repro_torch.paper.common import cli, emit

DRYRUN_DIR = Path("experiments/dryrun_torch")

MEASURED = frozenset()


def main(device="cuda", json_path=None) -> list:
    """One ``roofline_<arch>_<shape>`` row a single-pod cell. The rows only
    aggregate files; ``device`` is checked as every benchmark checks it and
    ``json_path`` is taken for the common signature."""
    resolve_device(device)
    if not DRYRUN_DIR.exists():
        return [emit("roofline_table", 0.0,
                     "missing:run repro_torch.launch.dryrun --all first")]
    rows = []
    for f in sorted(DRYRUN_DIR.glob("*_single.json")):
        d = json.loads(f.read_text())
        name = f"roofline_{d['arch']}_{d['shape']}"
        if "skipped" in d:
            rows.append(emit(name, 0.0, "skipped:sub-quadratic-only-shape"))
            continue
        if "error" in d:
            rows.append(emit(name, 0.0, f"error:{d['error'][:60]}"))
            continue
        t = d["terms_s"]
        temp_gb = d["memory"].get("temp_size_in_bytes", 0) / 1e9
        rows.append(emit(
            name,
            d.get("trace_s", 0.0) * 1e6,
            f"compute={t['compute']:.4f}s;memory={t['memory']:.4f}s;"
            f"collective={t['collective']:.4f}s;dominant={d['dominant']};"
            f"useful_flops_ratio={d['useful_flops_ratio']:.2f};"
            f"temp_gb={temp_gb:.1f}",
        ))
    return rows


if __name__ == "__main__":
    main(**cli(__doc__))

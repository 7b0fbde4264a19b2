"""Shared utilities of the benchmarks: timing and CSV rows.

Port of ``benchmarks/common.py``. Every benchmark prints ``name,us_per_call,derived``
rows; ``derived`` carries the benchmark's headline quantities (throughput,
accuracy, ...) as ``key=value`` fields joined by ``;``. On a card the clock
is read only after a synchronise, so a time covers the device's work.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Callable

import torch

__all__ = ["cli", "comparable", "emit", "fields", "sync", "timed", "write_json"]


def sync(device: str | torch.device) -> None:
    """Wait for the card's queued work (nothing to wait for on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def timed(fn: Callable, device: str | torch.device):
    """``(fn(), microseconds of that one call)``. The reference's benchmarks
    time one call with ``timeit_us(fn, iters=1, warmup=0)`` and then make
    another for its result; this keeps the timed call's result."""
    sync(device)
    t0 = time.perf_counter()
    out = fn()
    sync(device)
    return out, (time.perf_counter() - t0) * 1e6


def emit(name: str, us_per_call: float, derived: str) -> tuple[str, float, str]:
    print(f"{name},{us_per_call:.1f},{derived}", flush=True)
    return name, us_per_call, derived


def fields(derived: str) -> dict[str, str]:
    """A derived column's ``key=value`` fields, in order."""
    out = {}
    for part in derived.split(";"):
        key, _, value = part.partition("=")
        out[key] = value
    return out


def comparable(derived: str, measured) -> str:
    """The derived column without the fields that a run measures."""
    return ";".join(f"{k}={v}" for k, v in fields(derived).items() if k not in measured)


def write_json(path: str | None, data: dict) -> None:
    """Write a benchmark's results where ``path`` says (nowhere without one)."""
    if path:
        with open(path, "w") as f:
            json.dump(data, f, indent=2)
            f.write("\n")


def cli(doc: str) -> dict:
    """A benchmark's command line: ``--device`` (default ``cuda``) and ``--json``."""
    parser = argparse.ArgumentParser(description=doc,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--json", default=None, help="write the benchmark's results here")
    args = parser.parse_args()
    return dict(device=args.device, json_path=args.json)

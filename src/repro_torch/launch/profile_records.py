"""How many device records ``torch.profiler`` keeps of a short window's
kernels as the process ages, on the card (ROADMAP C-port-7).

    PYTHONPATH=src python -m repro_torch.launch.profile_records [--rounds 9] [--gap 9]

Each round profiles five spin kernels of increasing length
(``torch.cuda._sleep``, 20 000 to 100 000 cycles) in three windows: bare
(the spins, a synchronise); padded (50 ms of idle host time inside the
window before and after them); trailed (20 short spins launched after the
synchronise, inside the window). For each it prints how many of the five
the profiler's events hold and how many Kineto's own results hold
(``prof.profiler.kineto_results``), and whether a profiler session was
open before. Between rounds the card multiplies 4096 x 4096 matrices for
a moment and the host sleeps ``--gap`` seconds. One JSON line at the end.
Needs a card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch

__all__ = ["main"]

TARGETS = tuple(20_000 * (i + 1) for i in range(5))  # spin cycles of the five targets
WAYS = ("bare", "padded", "trailed")


def _window(way: str) -> tuple[int, int]:
    """(targets in the profiler's events, targets in Kineto's results)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        if way == "padded":
            time.sleep(0.05)
        for cycles in TARGETS:
            torch.cuda._sleep(cycles)
        torch.cuda.synchronize()
        if way == "padded":
            time.sleep(0.05)
        if way == "trailed":
            for _ in range(20):
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
    # A target spins for at least 20 000 cycles (~10 us); a trailing one ~1 us.
    events = sum(e.device_type == DeviceType.CUDA and "spin" in e.name
                 and e.time_range.end - e.time_range.start > 5.0 for e in prof.events())
    kineto = sum(e.device_type() == DeviceType.CUDA and "spin" in e.name()
                 and e.duration_ns() > 5_000 for e in prof.profiler.kineto_results.events())
    return events, kineto


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=9)
    ap.add_argument("--gap", type=float, default=9.0, help="host seconds between rounds")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_records needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    t0 = time.perf_counter()
    x = torch.randn(4096, 4096, device="cuda")
    rows = []
    for rnd in range(args.rounds):
        row = {"round": rnd, "t_s": time.perf_counter() - t0}
        for way in WAYS:
            open_before = torch._C._autograd._profiler_enabled()
            row[way] = dict(zip(("events", "kineto"), _window(way)), open_before=open_before)
        rows.append(row)
        print(f"t={row['t_s']:6.1f} s round {rnd}: targets kept of {len(TARGETS)} (events/kineto)"
              + "".join(f", {w} {row[w]['events']}/{row[w]['kineto']}" for w in WAYS)
              + f"; a session open before: {any(row[w]['open_before'] for w in WAYS)}", flush=True)
        for _ in range(200):
            x = torch.tanh(x @ x * 1e-3)
        torch.cuda.synchronize()
        time.sleep(args.gap)
    print(smi)
    print(json.dumps({"gpu": smi, "rounds": rows}))


if __name__ == "__main__":
    main()

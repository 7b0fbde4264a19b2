"""Rank the collectives of one dry-run cell by their per-device bytes: the
port of ``repro.launch.rank_collectives``.

  PYTHONPATH=src python -m repro_torch.launch.rank_collectives --arch X --shape Y [--sp]

The reference parses the compiled HLO and weighs each collective by the
trip counts of the loops around it. An eager step dispatches every
iteration, so here each call counts once: the cell runs as
``launch.dryrun.run_cell`` runs it, and each collective is charged to
its call site, the innermost frame of the call stack in
``repro_torch.models`` or ``repro_torch.launch`` (a collective of the
backward pass, launched by the autograd engine, lands on the frame that
called for the gradients, or on the ``backward`` of a ``models``
function, and is tagged with the autograd node that ran it). A site's bytes are the sum of its calls' result bytes; its
count stands where the reference prints the trip count. Both of the
reference's formats are printed: the ``TOTAL`` line and one line a site.
"""

from __future__ import annotations

import argparse
import os
import sys

from repro_torch.launch.dryrun import run_cell

__all__ = ["call_site", "rank"]

_HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_OWN = (os.path.join(_HERE, "models") + os.sep, os.path.join(_HERE, "launch") + os.sep)
_SKIP = (os.path.join(_HERE, "launch", "dryrun.py"),
         os.path.join(_HERE, "launch", "rank_collectives.py"))


def call_site() -> str:
    """``file:line function`` of the innermost frame in the port's models
    or launch packages (the dry-run's own frames aside)."""
    import torch

    node = torch._C._current_autograd_node()
    grad = f" ({node.name()})" if node is not None else ""
    f = sys._getframe(1)
    while f is not None:
        name = f.f_code.co_filename
        if name.startswith(_OWN) and name not in _SKIP:
            return f"{os.path.relpath(name, _HERE)}:{f.f_lineno} {f.f_code.co_name}{grad}"
        f = f.f_back
    return "<outside the port>" + grad


def rank(arch: str, shape_name: str, overrides=None, top: int = 18):
    """[(bytes, kind, calls, site)] of the cell's collectives, largest first
    (printed as the reference prints them)."""
    res = run_cell(arch, shape_name, print_analysis=False, overrides=overrides,
                   site=call_site)
    if "skipped" in res:
        print(res["skipped"])
        return []
    items = sorted(((b, kind, n, site) for (site, kind), (b, n) in res["sites"].items()),
                   reverse=True)
    total = sum(i[0] for i in items)
    print(f"TOTAL {total/1e9:.1f} GB/device/step across {len(items)} collective sites")
    for b, kind, n, site in items[:top]:
        print(f"{b/1e9:8.2f}GB {kind:16s} x{n:<4.0f} {site[:110]}")
    return items


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--sp", action="store_true")
    args = ap.parse_args(argv)
    rank(args.arch, args.shape, overrides={"sequence_parallel": True} if args.sp else None)


if __name__ == "__main__":
    main()

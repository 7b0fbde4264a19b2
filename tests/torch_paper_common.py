"""Helpers of the paper benchmarks' tests (``tests/test_torch_paper_*.py``).

Each test runs a benchmark of the port (``repro_torch.paper``) on the CPU and
the reference's benchmark of the same name (``benchmarks/``, ``repro`` on its
NumPy paths), and compares their rows' derived columns without the fields a
run measures (the port benchmark's ``MEASURED``). They also recompute
``chip_smoke.py``'s ``PAPER_REF``, the reference's rows that phase 14 holds
the card against.
"""

from __future__ import annotations

import contextlib
import functools
import importlib
import importlib.util
import io
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.paper.common import comparable

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The benchmarks' plain PyTorch paths on one thread, restored afterwards:
    their tensors are small, and the test runner's workers share the host's
    cores, where each worker's pool of intra-op threads would spin against
    the others'."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.cache
def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@contextlib.contextmanager
def reference_bench(name: str):
    """``benchmarks.<name>`` imported from the checkout, inside a
    monkeypatch context (also handed to the caller for further patches)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.syspath_prepend(str(ROOT))
        for key in [k for k in sys.modules if k == "benchmarks" or k.startswith("benchmarks.")]:
            mp.delitem(sys.modules, key)
        yield importlib.import_module(f"benchmarks.{name}"), mp


def printed_rows(fn, *args, **kwargs) -> dict[str, str]:
    """``{name: derived}`` of the ``name,us_per_call,derived`` rows ``fn`` prints."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        fn(*args, **kwargs)
    rows = {}
    for line in out.getvalue().splitlines():
        parts = line.split(",", 2)
        if len(parts) == 3 and not line.startswith("#") and parts[0] != "name":
            rows[parts[0]] = parts[2]
    return rows


def port_rows(rows) -> dict[str, str]:
    """``{name: derived}`` of rows a port benchmark returned."""
    return {name: derived for name, _us, derived in rows}


def comparable_rows(rows: dict[str, str], measured) -> dict[str, str]:
    return {name: comparable(derived, measured) for name, derived in rows.items()}

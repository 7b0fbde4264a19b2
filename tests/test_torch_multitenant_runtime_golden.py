"""Freshness of ``chip_smoke.py``'s multi-tenant runtime constants.

Phase 12d runs three tenants online on ``paper_cluster((20, 30, 40))``
over 240 windows with a ``TraceRecorder`` and compares the allocation,
satisfaction, fingerprints, the arbiter's log, the replan decisions and
the whole JSONL export (under the backend-name map) with the reference's,
kept as constants in the script. This test recomputes them from ``repro``
(``backend="numpy"`` for the allocation; the controllers' ``refine`` on its
default, which stays on NumPy at 90 machines) with the script's own
``mt_runtime``, so they cannot go stale.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

import repro.core as R  # noqa: E402
import repro.multitenant as RMT  # noqa: E402
import repro.runtime_stream as RS  # noqa: E402
from repro.obs import TraceRecorder, to_jsonl  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)


def test_runtime_constants():
    rec = TraceRecorder(name="mt")
    ms, res = cs.mt_runtime(np, R, RMT, RS, rec, dict(backend="numpy"), {})
    jsonl = to_jsonl(rec, strip_wall=True)
    assert cs.runtime_summary(np, ms, res, jsonl) == cs.MT_RUNTIME_REF
    assert all(d.backend == "numpy" for d in rec.dispatch_log)
    assert res.arbiter_log
